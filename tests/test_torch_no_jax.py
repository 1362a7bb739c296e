"""The port never imports JAX, nor anything of the JAX package.

tests/conftest.py imports JAX into every test process, so the check runs
in a fresh interpreter: it imports every tpu_spmv_torch module (and
chip_smoke), runs the CLIs on the CPU (SpMV auto, packed, the baselines
segsum, bcoo and dense, and ranked with the residency gate forced, so the
windowed and the column-striped routes run; SpMM, the triangular solve
and IC(0)-PCG), the flagship and scattered benches on small inputs, the
planner on a matrix large enough to be sampled, the calibration
protocol, the SpMV CLI's sigma sort and layout cache, the sweep and
analyze, and asserts that
neither `jax` nor `tpu_spmv` (the JAX
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
for argv in (["synthetic:banded_1k"],
             *(["synthetic:banded_1k", "--kernel", k]
               for k in ("packed", "segsum", "bcoo", "dense"))):
    rc = spmv.main([*argv, "--device", "cpu", "--validate-only"])
    assert rc == 0, rc
from tpu_spmv_torch import hw
l2, hw.H100_L2_BYTES = hw.H100_L2_BYTES, 0  # x past the residency gate
for argv in (["synthetic:banded_1k", "--kernel", "ranked"],
             ["synthetic:general_1k", "--kernel", "ranked", "--bin-blocks",
              "4"]):
    rc = spmv.main([*argv, "--device", "cpu", "--validate-only"])
    assert rc == 0, rc
hw.H100_L2_BYTES = l2
import os
from tpu_spmv_torch.bench import flagship, scattered_16m
os.environ.update(TPU_SPMV_BENCH_N="16", SCAT_M="256", SCAT_N="4096",
                  SCAT_PER_ROW="8", SCAT_STRIPE_COLS="1024")
assert flagship.main(["--device", "cpu"]) == 0
assert scattered_16m.main(["--device", "cpu"]) == 0
rc = spmm.main(["synthetic:banded_1k", "--batch", "3", "--device", "cpu",
                "--validate-only"])
assert rc == 0, rc
rc = sts.main(["synthetic:banded_1k", "--device", "cpu", "--validate-only"])
assert rc == 0, rc
rc = solve.main(["synthetic:banded_1k", "--iters", "25", "--precond", "ic0",
                 "--devices", "1", "--device", "cpu"])
assert rc == 0, rc
from tpu_spmv_torch.tune.model import tpu_plan
tpu_plan(spmv.load_input("synthetic:banded_100k"))  # samples 256 chunks
import tempfile
from tpu_spmv_torch import config
from tpu_spmv_torch.tools import analyze, sweep, tune
assert tune.measure(scale=0.02, device="cpu")
with tempfile.TemporaryDirectory() as tmp:
    cache = os.path.join(tmp, "lay.npz")
    for _ in range(2):  # writes, then loads the layout cache
        rc = spmv.main(["synthetic:powerlaw_100k", "--sigma", "-1",
                        "--layout-cache", cache, "--device", "cpu",
                        "--validate-only"])
        assert rc == 0, rc
    rc = sweep.main(["--out", os.path.join(tmp, "s.csv"), "--matrices",
                     "lap2d_32", "banded_1k", "--scale", "tiny", "--kernels",
                     "auto", "ranked", "--k", "1", "--srs", "8", "--device",
                     "cpu"])
    assert rc == 0, rc
assert analyze.format_overheads(spmv.load_input("synthetic:banded_1k"), 2,
                                (8,))["ranked"] > 0
assert config.RunConfig().k == 2
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
