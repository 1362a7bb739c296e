"""The port's SpMM (spmm_ranked, spmm_packed and the tools.spmm CLI) on
the CPU, against the JAX package's Pallas kernels in interpret mode on
the same layouts.

Each column must agree with the JAX result and with the serial CSR
oracle: RelL2 <= 1e-6 and Number Wrong 0 at the magnitude-aware 0.01.
B = 1 and an odd B = 5, as tests/test_fuzz_kernels.py runs them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_spmv.bench.matrices import (
    laplacian_2d, power_law, random_banded, random_general,
)
from tpu_spmv.formats import packed as jpacked
from tpu_spmv.formats import sell as jsell
from tpu_spmv.kernels.spmm import (
    spmm_packed as jax_spmm_packed, spmm_ranked as jax_spmm_ranked,
)
from tpu_spmv.reorder.rcm import rcm

from tpu_spmv_torch.bench.harness import validate
from tpu_spmv_torch.formats.convert import from_reference
from tpu_spmv_torch.formats.packed import PackedRanked
from tpu_spmv_torch.formats.sell import RankedSlabs
from tpu_spmv_torch.kernels.spmm import spmm_packed, spmm_ranked
from tpu_spmv_torch.tools import spmm as cli
from tpu_spmv_torch.tune import model

MATRICES = {
    "lap2d_37": lambda: laplacian_2d(37),
    "banded_640": lambda: random_banded(640, 25, 3),
    "general_900": lambda: random_general(900, 7),
    "powerlaw_1500": lambda: power_law(1500, 6, max_len=96),
}

_KERNELS = {
    "ranked": (jsell.RankedSlabs, jax_spmm_ranked, spmm_ranked),
    "packed": (jpacked.PackedRanked, jax_spmm_packed, spmm_packed),
}


def _agree_by_column(Y, Y_ref, mat, X):
    for b in range(X.shape[1]):
        for other in (Y_ref[:, b], mat.matvec(X[:, b])):
            wrong, rel = validate(Y[:, b], other)
            assert wrong == 0 and rel <= 1e-6, (b, wrong, rel)


@pytest.mark.parametrize("B", [1, 5])
@pytest.mark.parametrize("kernel", sorted(_KERNELS))
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_spmm_matches_pallas(name, kernel, B):
    mat = MATRICES[name]()
    mat = mat.permuted(rcm(mat.indptr, mat.indices))
    Layout, jax_fn, fn = _KERNELS[kernel]
    ref = Layout.from_csr(mat)
    X = np.random.default_rng(1).standard_normal((mat.n, B)).astype(
        np.float32
    )
    Y_ref = np.asarray(jax_fn(ref, jnp.asarray(X), interpret=True))
    Y = fn(from_reference(ref), torch.from_numpy(X)).numpy()
    assert Y.shape == (mat.m, B)
    _agree_by_column(Y, Y_ref, mat, X)


def test_spmm_grouped_and_bf16_layouts_match_oracle():
    """Grouped and ungrouped, f32 and bf16 layouts of both kernels give
    the same columns (bf16 against the bf16-rounded operator)."""
    from test_torch_formats import rounded

    mat = random_banded(1100, 70, 9)
    mat = mat.permuted(rcm(mat.indptr, mat.indices))
    X = np.random.default_rng(2).standard_normal((mat.n, 3)).astype(np.float32)
    for Layout, fn in ((RankedSlabs, spmm_ranked), (PackedRanked, spmm_packed)):
        for kw in (dict(), dict(allow_groups=False),
                   dict(val_dtype=torch.bfloat16)):
            Y = fn(Layout.from_csr(mat, **kw), torch.from_numpy(X)).numpy()
            oracle = rounded(mat) if kw.get("val_dtype") else mat
            for b in range(3):
                wrong, rel = validate(Y[:, b], oracle.matvec(X[:, b]))
                assert wrong == 0 and rel <= 1e-6, (Layout, kw, b)


CPU = ["--device", "cpu", "--validate-only"]


@pytest.mark.parametrize("spec", ["lap2d_32", "banded_1k", "general_1k"])
def test_cli_validates(spec, capsys):
    rc = cli.main([f"synthetic:{spec}", "3", "--batch", "5", *CPU])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "auto kernel:" in out
    assert "Number Wrong: 0 " in out


def test_cli_follows_the_plan(monkeypatch, tmp_path, capsys):
    """auto takes packed when the planner picks it (a low calibrated
    packed surcharge) and ranked otherwise; resident is always ranked;
    bf16 is validated against the rounded operator."""
    from test_torch_plan import pin_calibration

    args = ["synthetic:banded_1k", "--batch", "2", *CPU]
    pin_calibration(monkeypatch, tmp_path, {"packed_over": 0.1})
    assert model.tpu_plan(cli.load_input("synthetic:banded_1k"),
                          assume_rcm=True).kernel == "packed"
    assert cli.main(args) == 0
    assert "auto kernel: packed" in capsys.readouterr().out
    assert cli.main([*args, "--kernel", "resident", "--val-dtype",
                     "bf16"]) == 0
    out = capsys.readouterr().out
    assert "auto kernel" not in out and "bf16 values" in out
    pin_calibration(monkeypatch, tmp_path, {"packed_over": 100.0})
    assert cli.main(args) == 0
    assert "auto kernel: resident (ranked" in capsys.readouterr().out


@pytest.mark.parametrize("spec", ["lap2d_32", "banded_1k"])
def test_cli_windowed_validates(spec, capsys):
    """--kernel windowed runs spmm_ranked_windowed (its plain version
    here) whatever the gate says."""
    rc = cli.main([f"synthetic:{spec}", "--batch", "5", "--kernel",
                   "windowed", *CPU])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "windowed SpMM: ring" in out and "auto kernel" not in out
    assert "Number Wrong: 0 " in out


@pytest.mark.parametrize("args,item", [
    (["--devices", "2"], "A13"),
    (["--devices", "0"], "A13"),
    (["--overlap"], "A13"),
])
def test_unported_options_are_refused(args, item):
    with pytest.raises(SystemExit) as e:
        cli.main(["synthetic:lap2d_32", *args, *CPU])
    assert f"ROADMAP.md item {item}" in str(e.value)


def test_cli_refuses_timing_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["synthetic:lap2d_32"])
    with pytest.raises(SystemExit, match="timing needs a CUDA card"):
        cli.main(["synthetic:lap2d_32", "--device", "cpu"])


def test_spmm_wrappers_refuse_non_cuda_device():
    mat = laplacian_2d(20)
    lay = PackedRanked.from_csr(mat).to("meta")
    before = spmm_packed.launches
    with pytest.raises(ValueError, match="not a CUDA device"):
        spmm_packed(lay, torch.empty(mat.n, 2, device="meta"))
    assert spmm_packed.launches == before
