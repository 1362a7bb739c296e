"""The port never imports JAX, nor anything of the JAX package.

tests/conftest.py imports JAX into every test process, so the check runs
in a fresh interpreter: it imports every tpu_spmv_torch module (and
chip_smoke), runs the CLIs on the CPU (SpMV auto, packed and ranked with
the residency gate forced, so the windowed route runs; SpMM, the
triangular solve and IC(0)-PCG) and the planner on a matrix large enough
to be sampled, and asserts that neither `jax` nor `tpu_spmv` (the JAX
package, whose host modules the port carries copies of) was ever
loaded. A source scan backs it up.
"""

import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
import tpu_spmv_torch
names = [m.name for m in pkgutil.walk_packages(
    tpu_spmv_torch.__path__, "tpu_spmv_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from tpu_spmv_torch.tools import solve, spmm, spmv, sts
for argv in (["synthetic:banded_1k"], ["synthetic:banded_1k", "--kernel",
                                       "packed"]):
    rc = spmv.main([*argv, "--device", "cpu", "--validate-only"])
    assert rc == 0, rc
from tpu_spmv_torch import hw
l2, hw.H100_L2_BYTES = hw.H100_L2_BYTES, 0  # x past the residency gate
rc = spmv.main(["synthetic:banded_1k", "--kernel", "ranked", "--device",
                "cpu", "--validate-only"])
assert rc == 0, rc
hw.H100_L2_BYTES = l2
rc = spmm.main(["synthetic:banded_1k", "--batch", "3", "--device", "cpu",
                "--validate-only"])
assert rc == 0, rc
rc = sts.main(["synthetic:banded_1k", "--device", "cpu", "--validate-only"])
assert rc == 0, rc
rc = solve.main(["synthetic:banded_1k", "--iters", "25", "--precond", "ic0",
                 "--devices", "1", "--device", "cpu"])
assert rc == 0, rc
from tpu_spmv_torch.tune.plan import gpu_plan
gpu_plan(spmv.load_input("synthetic:banded_100k"))  # samples 256 chunks
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax",
                                                              "tpu_spmv"))
assert not loaded, loaded
print("modules", len(names))
"""


def test_port_imports_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    n = int(out.stdout.split("modules")[-1])
    assert n >= 25  # every module of the port was imported


def test_port_sources_have_no_jax_import():
    pattern = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    files = [*(REPO / "tpu_spmv_torch").rglob("*.py"), REPO / "chip_smoke.py",
             REPO / "tests" / "test_torch_gpu.py"]
    offenders = [str(p) for p in files if pattern.search(p.read_text())]
    assert not offenders


def test_port_sources_import_nothing_of_the_jax_package():
    """`tpu_spmv` is the JAX package. The pattern does not match the
    port's own `tpu_spmv_torch`: `_` is a word character, so there is no
    word boundary after `tpu_spmv` there."""
    pattern = re.compile(r"^\s*(from|import) tpu_spmv\b", re.M)
    files = [*(REPO / "tpu_spmv_torch").rglob("*.py"), REPO / "chip_smoke.py",
             REPO / "tests" / "test_torch_gpu.py"]
    offenders = [str(p) for p in files if pattern.search(p.read_text())]
    assert not offenders
