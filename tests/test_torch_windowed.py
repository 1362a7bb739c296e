"""The port's windowed kernels (spmv_dia_windowed, spmv_ranked_windowed,
spmm_ranked_windowed), their residency gates and the CLI routes that
reach them, on the CPU.

The plain versions run against the JAX package's windowed Pallas
kernels in interpret mode, on the JAX suite's own cases (tests/
test_dia.py, test_pallas_sell.py, test_kernels.py), on the same layout:
relative difference <= 1e-6 against the JAX result, RelL2 <= 1e-6 and
Number Wrong 0 against the serial oracle (bf16 layouts against the
bf16-rounded operator), and array-equal to the port's plain resident
version (the JAX tests hold their two kernels to assert_array_equal).
The CLI tests force the gates with a tiny L2 (hw.H100_L2_BYTES, what
the gates charge against off the card) and drive every route with
`--device cpu --validate-only`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_spmv.bench.matrices import laplacian_2d, random_banded
from tpu_spmv.formats import dia as jdia
from tpu_spmv.formats import sell as jsell
from tpu_spmv.kernels.dia import spmv_dia_windowed as jax_dia_windowed
from tpu_spmv.kernels.pallas_sell import (
    spmv_ranked_windowed as jax_ranked_windowed,
)
from tpu_spmv.kernels.spmm import spmm_ranked_windowed as jax_spmm_windowed
from tpu_spmv.reorder.rcm import rcm

from tpu_spmv_torch import hw
from tpu_spmv_torch.bench.harness import validate
from tpu_spmv_torch.formats.convert import from_reference
from tpu_spmv_torch.formats.dia import DiaSlabs
from tpu_spmv_torch.formats.packed import PackedRanked
from tpu_spmv_torch.formats.sell import RankedSlabs
from tpu_spmv_torch.kernels import dia as kdia
from tpu_spmv_torch.kernels import sell as ksell
from tpu_spmv_torch.kernels import spmm as kspmm
from tpu_spmv_torch.tools import spmm as spmm_cli
from tpu_spmv_torch.tools import spmv as spmv_cli
from tpu_spmv_torch.tune import plan

from test_torch_formats import rounded

CPU = ["--device", "cpu", "--validate-only"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _x(n, batch=None, seed=4):
    shape = (n,) if batch is None else (n, batch)
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32
    )


def _check(y, y_jax, y_resident, oracle, X):
    """The three bars of the module docstring, column by column."""
    assert np.array_equal(y, y_resident)
    assert _rel(y, y_jax) <= 1e-6
    ys, xs = y.reshape(y.shape[0], -1), X.reshape(X.shape[0], -1)
    for b in range(xs.shape[1]):
        wrong, rel = validate(ys[:, b], oracle.matvec(xs[:, b]))
        assert wrong == 0 and rel <= 1e-6, (b, wrong, rel)


@pytest.mark.parametrize("vdt", [None, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("grid", [40, 128])
def test_dia_windowed_matches_pallas(grid, vdt):
    """40: every arm unaligned; 128: the +-grid arms block-aligned."""
    mat = laplacian_2d(grid)
    ref = jdia.DiaSlabs.from_csr(mat, rows_per_tile=1024, val_dtype=vdt)
    lay = from_reference(ref)
    assert lay.vals.shape[0] > 1  # several tiles, so several windows
    x = _x(mat.n)
    y_jax = np.asarray(jax_dia_windowed(ref, jnp.asarray(x), interpret=True))
    y = kdia.spmv_dia_windowed(lay, torch.from_numpy(x)).numpy()
    y_res = kdia.spmv_dia_reference(lay, torch.from_numpy(x)).numpy()
    _check(y, y_jax, y_res, rounded(mat) if vdt else mat, x)


def _ranked_case(case):
    if case == "banded_384":
        return random_banded(384, 30, 6, seed=4), {}
    mat = laplacian_2d(48)
    mat = mat.permuted(rcm(mat.indptr, mat.indices))
    return mat, ({} if case == "lap2d_rcm_grouped" else
                 dict(allow_groups=False))


@pytest.mark.parametrize("case,lcols,grouped", [
    ("banded_384", np.int16, True),
    ("lap2d_rcm_grouped", np.uint8, True),
    ("lap2d_rcm_ungrouped", np.uint8, False),
])
def test_ranked_windowed_matches_pallas(case, lcols, grouped):
    mat, kw = _ranked_case(case)
    ref = jsell.RankedSlabs.from_csr(mat, **kw)
    assert np.asarray(ref.lcols).dtype == lcols
    assert (np.asarray(ref.grp_b0).size > 0) == grouped
    lay = from_reference(ref)
    x = _x(mat.n, seed=0)
    y_jax = np.asarray(
        jax_ranked_windowed(ref, jnp.asarray(x), interpret=True)
    )
    xt = torch.from_numpy(x)
    y = ksell.spmv_ranked_windowed(lay, xt).numpy()
    _check(y, y_jax, ksell.spmv_ranked_reference(lay, xt).numpy(), mat, x)


def test_spmm_windowed_matches_pallas():
    B = 3
    mat = random_banded(640, 40, 7, seed=6)
    ref = jsell.RankedSlabs.from_csr(mat)
    lay = from_reference(ref)
    X = _x(mat.n, B, seed=7)
    Y_jax = np.asarray(jax_spmm_windowed(ref, jnp.asarray(X), interpret=True))
    Xt = torch.from_numpy(X)
    Y = kspmm.spmm_ranked_windowed(lay, Xt).numpy()
    assert Y.shape == (mat.m, B)
    _check(Y, Y_jax, kspmm.spmm_ranked_reference(lay, Xt).numpy(), mat, X)


def test_windowed_plain_versions_read_only_the_window():
    """A tile base off by one block leaves the tile's lowest window
    blocks outside its window, where the plain version (which indexes
    the window, never x) reads 0, as the kernel does."""
    mat = random_banded(20000, 90, 11, seed=1)
    lay = RankedSlabs.from_csr(mat, tile_k=512)
    T = lay.win_b0.numel()
    assert T > 4
    x = torch.from_numpy(_x(mat.n))
    good = ksell.spmv_ranked_windowed(lay, x)
    lay.win_b0[T // 2] += 1
    bad = ksell.spmv_ranked_windowed(lay, x)
    assert not torch.equal(good, bad)


def test_windows_leave_out_the_all_pad_tail():
    """The reference's last tile_b0 counts the all-pad tail's base-0
    sub-tiles, so its win_w spans all of x here; the port's windows
    (real_windows) cover each tile's real sub-tiles only, and the
    kernels' results do not change."""
    mat = random_banded(20000, 90, 11, seed=1)
    lay = RankedSlabs.from_csr(mat, tile_k=512)
    assert int(lay.sub_chunk[-1]) == lay.num_chunks  # an all-pad tail
    assert lay.win_w >= mat.n // 128 and lay.win_span < lay.win_w // 2
    assert torch.equal(lay.win_b0[:-1], lay.tile_b0[:-1])
    assert int(lay.win_b0[-1]) > int(lay.tile_b0[-1]) == 0
    ref = jsell.RankedSlabs.from_csr(mat, tile_k=512)
    port = from_reference(ref)
    assert torch.equal(port.win_b0, lay.win_b0)
    assert port.win_span == lay.win_span


def test_residency_gates_charge_x_against_half_the_l2(monkeypatch):
    mat = laplacian_2d(64)
    dia = DiaSlabs.from_csr(mat, rows_per_tile=1024)
    ranked = RankedSlabs.from_csr(mat)
    assert kdia.dia_x_fits(dia) and ksell.resident_x_fits(ranked)
    assert not kdia.dia_x_fits(dia, budget_frac=1e-6)
    assert not ksell.resident_x_fits(ranked, budget_frac=1e-6)
    # x of n floats plus the guard blocks, B columns of it for an SpMM.
    n_pad = (-(-mat.n // 128) + 2) * 128
    monkeypatch.setattr(hw, "H100_L2_BYTES", 2 * 4 * n_pad * 3)
    assert ksell.resident_x_fits(ranked, batch=3)
    assert not ksell.resident_x_fits(ranked, batch=4)


def test_window_refusals_name_their_size():
    mat = laplacian_2d(64)
    ranked = RankedSlabs.from_csr(mat)
    need = ksell.window_bytes(ranked, 3)
    assert need == ranked.win_w * 128 * 3 * 4
    ksell.check_window(ranked, 3, budget=need)
    with pytest.raises(ValueError, match=f"{need} bytes"):
        ksell.check_window(ranked, 3, budget=need - 1)
    dia = DiaSlabs.from_csr(mat)
    span = 2 * 64
    assert kdia.dia_window_rows(dia, hw.H100_SMEM_PER_BLOCK) == 4096
    assert kdia.dia_window_rows(dia, (1024 + span) * 4) == 1024
    with pytest.raises(ValueError, match=f"{(128 + span) * 4} bytes"):
        kdia.dia_window_rows(dia, (128 + span) * 4 - 1)


@pytest.fixture
def tiny_l2(monkeypatch):
    """No x passes the residency gates (the windowed routes engage)."""
    monkeypatch.setattr(hw, "H100_L2_BYTES", 0)


@pytest.mark.parametrize("argv,route", [
    (["synthetic:lap2d_32"], "HBM-windowed DIA kernel"),
    (["synthetic:banded_1k", "--kernel", "ranked"], "HBM-windowed kernel"),
    (["synthetic:lap2d_32", "--kernel", "ranked", "--rcm", "always",
      "--val-dtype", "bf16"], "HBM-windowed kernel"),
])
def test_spmv_cli_takes_the_windowed_route(tiny_l2, argv, route, capsys):
    assert spmv_cli.main([*argv, *CPU]) == 0
    out = capsys.readouterr().out
    assert "exceeds the L2 residency budget" in out and route in out
    assert "Number Wrong: 0 " in out


def test_spmv_cli_packed_fallback_takes_the_windowed_route(
        tiny_l2, monkeypatch, capsys):
    def overflow(*args, **kwargs):
        raise ValueError("packed-delta range exceeded")

    monkeypatch.setattr(PackedRanked, "from_csr", overflow)
    assert spmv_cli.main(["synthetic:banded_1k", "--kernel", "packed",
                          *CPU]) == 0
    out = capsys.readouterr().out
    assert "falling back to ranked" in out
    assert "using the HBM-windowed kernel" in out


def test_spmv_cli_refuses_binned_layouts_past_the_gate(tiny_l2):
    with pytest.raises(SystemExit, match="ROADMAP.md item A10"):
        spmv_cli.main(["synthetic:general_1k", "--kernel", "ranked",
                       "--bin-blocks", "4", *CPU])


def test_spmv_cli_rebuilds_a_window_too_large(tiny_l2, monkeypatch, capsys):
    monkeypatch.setattr(hw, "H100_SMEM_PER_BLOCK", 48 * 1024)
    assert spmv_cli.main(["synthetic:lap2d_256", "--kernel", "ranked",
                          *CPU]) == 0
    out = capsys.readouterr().out
    assert "rebuilding layout at tile 1024" in out
    assert "tile 512, window 72 blocks (36 KB" in out


def test_sell_cli_warns_past_the_gate(tiny_l2, capsys):
    assert spmv_cli.main(["synthetic:banded_1k", "--kernel", "sell",
                          *CPU]) == 0
    assert "sell kernel has no windowed variant" in capsys.readouterr().out


@pytest.mark.parametrize("kernel", ["auto", "windowed"])
def test_spmm_cli_takes_the_windowed_route(tiny_l2, kernel, capsys):
    assert spmm_cli.main(["synthetic:banded_1k", "--batch", "3", "--kernel",
                          kernel, *CPU]) == 0
    out = capsys.readouterr().out
    assert "windowed SpMM: tile" in out and "1 column pass(es) of B'=3" in out
    if kernel == "auto":
        assert "auto kernel: windowed" in out
    assert "Number Wrong: 0 " in out


def test_spmm_cli_auto_skips_packed_past_the_gate(tiny_l2, monkeypatch,
                                                   capsys):
    """The planner keeps packed out past the gate; a packed plan that
    reaches the CLI all the same (forced here) is dropped there."""
    monkeypatch.setattr(plan, "packed_x_fits", lambda mat: True)
    monkeypatch.setattr(plan, "SPMM_PACKED_OVER_RANKED", 0.1)
    assert spmm_cli.main(["synthetic:banded_1k", "--batch", "2", *CPU]) == 0
    out = capsys.readouterr().out
    assert "packed layout past the L2 residency budget" in out
    assert "auto kernel: windowed" in out


def test_spmm_cli_splits_columns(tiny_l2, monkeypatch, capsys):
    """A window too large at tile 512 for B columns runs B' < B column
    passes; one that cannot fit at one column is refused."""
    monkeypatch.setattr(hw, "H100_SMEM_PER_BLOCK", 40 * 1024)
    assert spmm_cli.main(["synthetic:lap2d_256", "--batch", "5", "--rcm",
                          "always", *CPU]) == 0
    out = capsys.readouterr().out
    assert "rebuilding layout at tile 512" in out
    assert "5 column pass(es) of B'=1" in out and "Number Wrong: 0 " in out
    monkeypatch.setattr(hw, "H100_SMEM_PER_BLOCK", 1024)
    with pytest.raises(SystemExit, match="no windowed SpMM path"):
        spmm_cli.main(["synthetic:lap2d_256", "--batch", "5", "--kernel",
                       "windowed", *CPU])


def test_planner_keeps_packed_off_past_the_gate(monkeypatch):
    mat = laplacian_2d(64)
    mat = mat.permuted(rcm(mat.indptr, mat.indices))
    monkeypatch.setattr(plan, "PACKED_OVER_RANKED", 0.1)
    assert plan.gpu_plan(mat, assume_rcm=True).kernel == "packed"
    monkeypatch.setattr(hw, "H100_L2_BYTES", 0)
    p = plan.gpu_plan(mat, assume_rcm=True)
    assert p.kernel == "ranked" and "no windowed variant" in p.reason
