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
The window table that the ranked pair walks (formats/sell.window_fields)
is held to a brute-force recomputation, and its host check to tables
built by hand. The CLI tests force the gates with a tiny L2
(hw.H100_L2_BYTES, what the gates charge against off the card) and drive
every route with `--device cpu --validate-only`.
"""

import dataclasses


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
from tpu_spmv_torch.formats import sell as fsell
from tpu_spmv_torch.formats.sell import RankedSlabs, window_fields
from tpu_spmv_torch.kernels import dia as kdia
from tpu_spmv_torch.kernels import sell as ksell
from tpu_spmv_torch.kernels import spmm as kspmm
from tpu_spmv_torch.tools import spmm as spmm_cli
from tpu_spmv_torch.tools import spmv as spmv_cli
from tpu_spmv_torch.tune import plan

from test_torch_formats import rounded
from test_torch_gpu import _jumping, _long_row

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
    """A step's range off by one block leaves the step's lowest blocks
    outside its range, where the plain versions (which index the range,
    never x) read 0, as the kernels do; a range cut short at the top
    does the same to its highest blocks (by the paired-read blocks past
    the greatest base, so the block of the greatest base drops out)."""
    mat = random_banded(20000, 90, 11, seed=1)
    lay = RankedSlabs.from_csr(mat, tile_k=512)
    T = lay.step_lo.numel()
    assert T > 4
    x = torch.from_numpy(_x(mat.n))
    X = torch.from_numpy(_x(mat.n, 3))
    good = ksell.spmv_ranked_windowed(lay, x)
    good_X = kspmm.spmm_ranked_windowed(lay, X)
    assert torch.equal(good, ksell.spmv_ranked_reference(lay, x))
    reads = 2 * max((lay.rank_nb + 1) // 2, 1)
    for field, delta in (("step_lo", 1), ("step_hi", -reads)):
        t = getattr(lay, field)
        t[T // 2] += delta
        assert not torch.equal(good, ksell.spmv_ranked_windowed(lay, x))
        assert not torch.equal(good_X, kspmm.spmm_ranked_windowed(lay, X))
        t[T // 2] -= delta


def test_windows_leave_out_the_all_pad_tail():
    """The reference's last tile_b0 counts the all-pad tail's base-0
    sub-tiles, so its win_w spans all of x here; no step of the port's
    window table walks the tail, so its ring stays a few blocks, and the
    table from_reference rebuilds is the same."""
    mat = random_banded(20000, 90, 11, seed=1)
    lay = RankedSlabs.from_csr(mat, tile_k=512)
    assert int(lay.sub_chunk[-1]) == lay.num_chunks  # an all-pad tail
    walked = int(lay.seg_ptr[lay.step_seg[-1]])
    assert walked == int(lay.chunk_ptr[-1]) < lay.num_subtiles
    assert lay.win_w >= mat.n // 128 and lay.ring_blocks < lay.win_w // 8
    ref = jsell.RankedSlabs.from_csr(mat, tile_k=512)
    port = from_reference(ref)
    for f in ("step_seg", "step_lo", "step_hi"):
        assert torch.equal(getattr(port, f), getattr(lay, f)), f
    assert (port.ring_blocks, port.step_subtiles) == (
        lay.ring_blocks, lay.step_subtiles)


def _delta_base(lay, s, r):
    word = int(lay.sub_dlo[s] if r < 4 else lay.sub_dhi[s]) & 0xFFFFFFFF
    return int(lay.sub_b0[s]) + ((word >> (8 * (r % 4))) & 255)


def _brute_table(lay, q):
    """The window table by loops: segments taken into a step until it
    holds q sub-tiles and STEP_SEGMENTS segments, or the next one would
    take it past 2q sub-tiles, each step's range from
    its sub-tiles' 8 window bases, and R the largest set union of two
    consecutive steps' blocks."""
    sp = lay.seg_ptr.tolist()
    G = len(sp) - 1
    steps = [[]]
    for j in range(G):
        steps[-1].append(j)
        segs = steps[-1]
        if (sp[j + 1] - sp[segs[0]] >= q
                and len(segs) >= fsell.STEP_SEGMENTS) or (
                j + 1 < G and sp[j + 2] - sp[segs[0]] > 2 * q):
            steps.append([])
    if not steps[-1]:
        steps.pop()
    reads = 2 * max((lay.rank_nb + 1) // 2, 1)
    lo, hi = [], []
    for segs in steps:
        bases = [_delta_base(lay, s, r) for j in segs
                 for s in range(sp[j], sp[j + 1]) for r in range(8)]
        lo.append(min(bases) if bases else 0)
        hi.append(max(bases) + reads if bases else 0)
    blocks = [set(range(a, b)) for a, b in zip(lo, hi)]
    ring = max([1] + [len(b) for b in blocks]
               + [len(a | b) for a, b in zip(blocks, blocks[1:])])
    return [j[0] for j in steps] + [len(sp) - 1], lo, hi, ring


def _table_case(case):
    """(layout, step size) of the window-table cases."""
    if case == "lap2d_rcm":
        mat = laplacian_2d(48)
        return RankedSlabs.from_csr(mat.permuted(rcm(mat.indptr,
                                                     mat.indices))), 8
    if case == "split_chunk":
        lay = RankedSlabs.from_csr(_long_row())
        assert lay.split_seg.shape[1] > 0
        return lay, 8
    if case == "jumping":
        return RankedSlabs.from_csr(_jumping()).with_steps(1), 1
    if case == "bf16_grouped":
        mat = random_banded(3000, 90, 11, seed=1)
        lay = RankedSlabs.from_csr(mat.permuted(rcm(mat.indptr, mat.indices)),
                                   val_dtype=torch.bfloat16)
        assert lay.group_code and lay.vals.dtype == torch.bfloat16
        return lay, 8
    lay = RankedSlabs.from_csr(random_banded(384, 30, 6, seed=4))
    assert lay.lcols.dtype == torch.int16
    return lay.with_steps(4), 4


_TABLE_CASES = ["lap2d_rcm", "split_chunk", "jumping", "bf16_grouped",
                "int16_lcols"]


@pytest.mark.parametrize("case", _TABLE_CASES)
def test_window_table_matches_brute_force(case):
    """Steps, ranges and the step size against loops over the slots;
    every slot of a walked sub-tile (padding included) reads a block of
    its step's range; the plain windowed version equals the resident
    one."""
    lay, q = _table_case(case)
    step_seg, lo, hi, _ = _brute_table(lay, q)
    assert lay.step_subtiles == q
    sp = lay.seg_ptr.tolist()
    held = [sp[b] - sp[a] for a, b in zip(step_seg, step_seg[1:])]
    assert lay.stage_subtiles == max(held)
    assert lay.step_seg.tolist() == step_seg
    assert lay.step_lo.tolist() == lo and lay.step_hi.tolist() == hi
    if case == "jumping":
        assert bool((lay.step_lo.diff() < 0).any())
    sp = lay.seg_ptr.tolist()
    lcols = lay.lcols.view(-1, 8, 128).long()
    for i in range(len(lo)):
        for s in range(sp[step_seg[i]], sp[step_seg[i + 1]]):
            for r in range(8):
                blk = _delta_base(lay, s, r) + (lcols[s, r] >> 7)
                assert lo[i] <= int(blk.min()) and int(blk.max()) < hi[i]
    x = torch.from_numpy(_x(lay.n))
    assert torch.equal(ksell.spmv_ranked_windowed(lay, x),
                       ksell.spmv_ranked_reference(lay, x))


@pytest.mark.parametrize("case", _TABLE_CASES)
def test_ring_is_the_largest_union_of_two_steps(case):
    lay, q = _table_case(case)
    assert lay.ring_blocks == _brute_table(lay, q)[3]
    width = lay.step_hi - lay.step_lo
    assert lay.ring_blocks >= int(width.max())


@pytest.mark.parametrize("how", ["lo_up", "hi_down", "ring_short",
                                 "steps_short"])
def test_window_check_raises_on_a_table_that_misses_a_slot(how):
    """Tables built by hand are refused when the container is made: a
    step whose range misses its lowest or highest slot block, a ring
    smaller than a step, a table that does not reach the last segment."""
    lay, _ = _table_case("split_chunk")
    i = int((lay.step_hi - lay.step_lo).argmax())
    lo, hi = lay.step_lo.clone(), lay.step_hi.clone()
    change = {}
    if how == "lo_up":
        lo[i] += 1
        change = dict(step_lo=lo)
    elif how == "hi_down":  # drop the greatest base's own block
        hi[i] -= 2 * max((lay.rank_nb + 1) // 2, 1)
        change = dict(step_hi=hi)
    elif how == "ring_short":
        change = dict(ring_blocks=int(hi[i] - lo[i]) - 1)
    else:
        change = dict(step_seg=lay.step_seg[:-1].clone(), step_lo=lo[:-1],
                      step_hi=hi[:-1])
    match = {"lo_up": "outside its step's range",
             "hi_down": "outside its step's range",
             "ring_short": "past the ring",
             "steps_short": "segment count"}[how]
    with pytest.raises(ValueError, match=match):
        dataclasses.replace(lay, **change)
    dataclasses.replace(lay, **window_fields(
        lay.seg_ptr, lay.sub_b0, lay.sub_dlo, lay.sub_dhi, lay.rank_nb))


@pytest.mark.parametrize("q", [1, 2, 4, 16])
def test_with_steps_recuts_the_table(q):
    """with_steps cuts the table anew at q sub-tiles a step (fewer a
    step, a smaller ring) and the results do not change."""
    lay, _ = _table_case("lap2d_rcm")
    at_q = lay.with_steps(q)
    assert at_q.step_subtiles == q
    assert at_q.step_seg.tolist() == _brute_table(lay, q)[0]
    if q < lay.step_subtiles:
        assert at_q.ring_blocks < lay.ring_blocks
    x = torch.from_numpy(_x(lay.n))
    assert torch.equal(ksell.spmv_ranked_windowed(at_q, x),
                       ksell.spmv_ranked_windowed(lay, x))


def test_fit_window_splits_columns_only_when_the_ring_does_not_fit(
        monkeypatch, capsys):
    """At a budget the ring fits B columns wide, fit_window keeps the
    table and B; a byte less, it cuts the table at a smaller step first,
    and splits the columns only when one sub-tile a step is too wide."""
    mat = laplacian_2d(64)
    lay = RankedSlabs.from_csr(mat.permuted(rcm(mat.indptr, mat.indices)))
    B = 5
    monkeypatch.setattr(hw, "H100_SMEM_PER_BLOCK",
                        ksell.window_bytes(lay, B))
    out, cols = spmv_cli.fit_window(lay, B, torch.device("cpu"))
    assert out is lay and cols == B
    assert "cutting" not in capsys.readouterr().out
    monkeypatch.setattr(hw, "H100_SMEM_PER_BLOCK",
                        ksell.window_bytes(lay, B) - 1)
    out, cols = spmv_cli.fit_window(lay, B, torch.device("cpu"))
    assert out.step_subtiles == lay.step_subtiles // 2 and cols == B
    one = lay.with_steps(1)
    monkeypatch.setattr(hw, "H100_SMEM_PER_BLOCK",
                        ksell.window_bytes(one, B) - 1)
    out, cols = spmv_cli.fit_window(lay, B, torch.device("cpu"))
    assert out.step_subtiles == 1 and cols == 3
    assert "cutting the window table at 1 sub-tile(s)" in (
        capsys.readouterr().out)


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
    cap = ranked.stage_subtiles  # f32 values, uint8 columns
    stage = cap * 1024 * 4 + -(-cap * 1024 // 128) * 128 + 3 * -(
        -(cap + 4) * 4 // 128) * 128
    assert need == (ranked.ring_blocks * 128 * 3 * 4 + 2 * stage
                    + ksell.RING_STATIC_BYTES)
    ksell.check_window(ranked, 3, budget=need)
    with pytest.raises(ValueError, match=f"{need} bytes"):
        ksell.check_window(ranked, 3, budget=need - 1)
    dia = DiaSlabs.from_csr(mat)
    span, d = 2 * 64, 5

    def ring_bytes(rows):  # ring, two stages and offsets
        return (4 * -(-(span + 2 * rows) // 32) * 32 + 2 * d * rows * 4
                + 4 * d)

    assert kdia.dia_ring(dia, hw.H100_SMEM_PER_BLOCK).step_rows == 1024
    assert kdia.dia_ring(dia, ring_bytes(1024)).step_rows == 1024
    assert kdia.dia_ring(dia, ring_bytes(1024) - 1).step_rows == 512
    with pytest.raises(ValueError, match=f"{ring_bytes(128)} bytes"):
        kdia.dia_ring(dia, ring_bytes(128) - 1)


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
    """A ring of 21 blocks and stages of 8 sub-tiles (93,472 bytes) at 8
    sub-tiles a step, past a 64 KB budget: the table is cut at 4
    sub-tiles a step, a 13-block ring and stages of 4 (48,416 bytes)."""
    monkeypatch.setattr(hw, "H100_SMEM_PER_BLOCK", 64 * 1024)
    assert spmv_cli.main(["synthetic:lap2d_256", "--kernel", "ranked",
                          *CPU]) == 0
    out = capsys.readouterr().out
    assert "cutting the window table at 4 sub-tile(s) a step: ring 21" in out
    assert "ring 13 blocks (47 KB of shared memory)" in out


def test_sell_cli_warns_past_the_gate(tiny_l2, capsys):
    assert spmv_cli.main(["synthetic:banded_1k", "--kernel", "sell",
                          *CPU]) == 0
    assert "sell kernel has no windowed variant" in capsys.readouterr().out


@pytest.mark.parametrize("kernel", ["auto", "windowed"])
def test_spmm_cli_takes_the_windowed_route(tiny_l2, kernel, capsys):
    assert spmm_cli.main(["synthetic:banded_1k", "--batch", "3", "--kernel",
                          kernel, *CPU]) == 0
    out = capsys.readouterr().out
    assert "windowed SpMM: ring" in out and "1 column pass(es) of B'=3" in out
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
    """A ring too large at one sub-tile a step for B columns (9 blocks
    and stages of 2 sub-tiles: 25,888 bytes at one column, 30,496 at
    two) runs B' < B column passes; one that cannot fit at one column is
    refused."""
    monkeypatch.setattr(hw, "H100_SMEM_PER_BLOCK", 28 * 1024)
    assert spmm_cli.main(["synthetic:lap2d_256", "--batch", "5", "--rcm",
                          "always", *CPU]) == 0
    out = capsys.readouterr().out
    assert "cutting the window table at 1 sub-tile(s) a step" in out
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
