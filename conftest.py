"""Builds the JAX package's C++ host core, tpu_spmv/cpp/libtpuspmv.so,
once, before any test process starts.

tpu_spmv/reorder/native.py builds the library in place on first use.
Under pytest-xdist every worker collects every test module at once, so
one worker may find a library another is still writing, its mtime
already past the source's: it skips the build, fails to load the file,
and skips every native test it runs. Here the controller (or a run
without workers) runs make first, so the workers find the library
whole. Where make fails (no toolchain) nothing changes: the native
tests skip, as they would without this file. Nothing of tpu_spmv is
imported, so tests/conftest.py still sets up JAX before anything does.
"""

import pathlib
import subprocess

_CPP_DIR = pathlib.Path(__file__).resolve().parent / "tpu_spmv" / "cpp"


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker
        return
    try:
        subprocess.run(["make", "-C", str(_CPP_DIR)], capture_output=True,
                       timeout=600, check=False)
    except (OSError, subprocess.SubprocessError):
        pass
