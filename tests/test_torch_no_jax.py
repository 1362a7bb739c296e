"""The port never imports JAX.

tests/conftest.py imports JAX into every test process, so the check runs
in a fresh interpreter: it imports every tpu_spmv_torch module (and
chip_smoke), runs the CLI once on the CPU, and asserts that `jax` was
never loaded. A source scan backs it up.
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
from tpu_spmv_torch.tools import spmv
rc = spmv.main(["synthetic:banded_1k", "--device", "cpu", "--validate-only"])
assert rc == 0, rc
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
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
    assert n >= 15  # every module of the port was imported


def test_port_sources_have_no_jax_import():
    pattern = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    files = [*(REPO / "tpu_spmv_torch").rglob("*.py"), REPO / "chip_smoke.py",
             REPO / "tests" / "test_torch_gpu.py"]
    offenders = [str(p) for p in files if pattern.search(p.read_text())]
    assert not offenders
