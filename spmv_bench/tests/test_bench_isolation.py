"""No run loads JAX or the JAX package, the reference loads nothing of
the program, and without a card the command fails with no result."""

import ast
import json
import os
import subprocess
import sys

import pytest

from spmv_bench import run as harness

ENV = dict(os.environ, PYTHONPATH=str(harness.ROOT), CUDA_VISIBLE_DEVICES="")
ENV.pop("JAX_PLATFORMS", None)


def _python(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                          env=ENV, capture_output=True, text=True,
                          timeout=600)


def test_forbidden_is_compared_by_whole_top_level_name():
    assert harness.forbidden_modules(
        ["tpu_spmv_torch", "tpu_spmv_torch.kernels", "jax_free", "numpy"]
    ) == []
    assert harness.forbidden_modules(
        ["tpu_spmv.formats", "jaxlib.xla_client", "jax", "flax.linen"]
    ) == ["flax", "jax", "jaxlib", "tpu_spmv"]


def test_a_cpu_run_loads_no_jax():
    out = _python(
        "import torch, json\n"
        "from spmv_bench import run\n"
        "r = run.run_cell('hpcg_104.pcg_ic0', 7, 0.2, True,"
        " torch.device('cpu'), config={'nx': 8, 'ny': 8, 'nz': 8})\n"
        "import tpu_spmv_torch\n"
        "print(json.dumps([r['correct'], run.forbidden_modules()]))\n")
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.splitlines()[-1]) == [True, []]


def test_reference_loads_nothing_of_the_program():
    out = _python(
        "import sys, torch\n"
        "import spmv_bench.reference.spmv, spmv_bench.reference.cg\n"
        "from spmv_bench import run\n"
        "for cell in ('hpcg_104.pcg_ic0', 'hpcg_104.cg', 'ecology1.spmv'):\n"
        "    run.run_cell(cell, 3, 0.1, False, torch.device('cpu'),"
        " config={'nx': 6, 'ny': 6, 'nz': 6}, control=True)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'tpu_spmv_torch', 'tpu_spmv', 'jax', 'jaxlib', 'flax'}))\n")
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.splitlines()[-1] == "[]"
    for path in (harness.HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in (
                    "tpu_spmv_torch", "tpu_spmv", "jax", "jaxlib"), path


@pytest.mark.parametrize("cell", ["ecology1.spmv", "hpcg_104x4.cg"])
def test_no_card_fails_without_a_result(cell):
    out = subprocess.run(
        [sys.executable, "-m", "spmv_bench.run", "--workload",
         cell, "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, env=ENV, capture_output=True, text=True,
        timeout=600)
    assert out.returncode != 0
    assert "correct" not in out.stdout
    assert "CUDA card" in out.stderr
