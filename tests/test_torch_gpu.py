"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

Marked `gpu`; every test skips inside its fixture when no CUDA card is
present (never at import, so every test worker collects the same tests).
This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerances: kernel and plain version both sum in f32, in different
orders and with or without fused multiply-add, so they agree to
1e-5 * max(1, max |y|), not bit for bit. Against the serial CSR oracle
the bar is the suite's: Number Wrong 0 at the magnitude-aware 0.01 and
RelL2 <= 1e-6 (bf16 layouts against the bf16-rounded operator; SpMM
column by column). A windowed kernel is also held to its resident twin
on the same layout: spmv_ranked_windowed sums in spmv_ranked's order
with the same fused multiply-adds, and spmv_dia_windowed in spmv_dia's,
so each pair gives the same bits; the SpMM twins agree to 1e-5. The triangular solves' plain versions repeat the
kernels' arithmetic (one fused multiply-add a slot, in slot order), so
kernel and plain version give the same bits; they carry rounding along
the dependency chain, so against the f64 oracle they agree to RelL2 <=
1e-5, with Number Wrong 0 at 0.01 for x = ones.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from tpu_spmv_torch import hw
from tpu_spmv_torch.bench.harness import bench_spmv, bench_spmv_cold, validate
from tpu_spmv_torch.bench.matrices import (
    laplacian_2d, random_banded, random_general, scattered_wide,
    variable_stencil,
)
from tpu_spmv_torch.formats.csr import CSRMatrix
from tpu_spmv_torch.formats.dia import DiaSlabs
from tpu_spmv_torch.formats.packed import PackedRanked
from tpu_spmv_torch.formats.sell import RankedSlabs, SellSlabs
from tpu_spmv_torch.kernels.dia import (
    spmv_dia, spmv_dia_reference, spmv_dia_windowed,
    spmv_dia_windowed_reference,
)
from tpu_spmv_torch.kernels.packed import spmv_packed, spmv_packed_reference
from tpu_spmv_torch.kernels.sell import (
    spmv_ranked, spmv_ranked_reference, spmv_ranked_windowed,
    spmv_ranked_windowed_reference, spmv_sell, spmv_sell_reference,
    window_bytes,
)
from tpu_spmv_torch.kernels.spmm import (
    spmm_packed, spmm_packed_reference, spmm_ranked, spmm_ranked_reference,
    spmm_ranked_windowed, spmm_ranked_windowed_reference,
)
from tpu_spmv_torch.kernels.striped import (
    StripedRanked, spmv_striped, spmv_striped_reference,
)
from tpu_spmv_torch.reorder import rcm
from tpu_spmv_torch.kernels.sts import (
    lower_solve_blocks, lower_solve_blocks_reference, lower_solve_ranked,
    lower_solve_ranked_reference,
)
from tpu_spmv_torch.bench.solve_times import bidiagonal_chain, hpcg27
from tpu_spmv_torch.sts.host import build_sts, compute_b, split_lu
from tpu_spmv_torch.sts.ic0 import (
    IC0Preconditioner, _ic0_schedules, capture_pcg_step, ic0_factor,
    pcg_ic0_init, pcg_ic0_solve,
)
from tpu_spmv_torch.sts.solve import (
    LowerSolveLayout, lower_solve, lower_solve_reference,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rcm(mat):
    return mat.permuted(rcm(mat.indptr, mat.indices))


def _long_row(row=1500, length=400, seed=0):
    """random_banded(3000, 90, 11) with row `row` replaced by `length`
    nonzeros spread over all columns: its chunk has 50 sub-tiles, split
    into several segments (tests/test_torch_segments.py holds the table)."""
    mat = random_banded(3000, 90, 11, seed=1)
    rows = np.repeat(np.arange(mat.m), np.diff(mat.indptr))
    keep = rows != row
    cols = np.unique(np.linspace(0, mat.n - 1, length).astype(np.int64))
    vals = np.random.default_rng(seed).standard_normal(cols.size)
    return CSRMatrix.from_coo(
        np.concatenate([rows[keep], np.full(cols.size, row)]),
        np.concatenate([mat.indices[keep], cols]),
        np.concatenate([mat.data[keep], vals.astype(np.float32)]),
        mat.shape,
    )


def _wide(m=512, n=8192, per_row=6, seed=3, long_row=None):
    """m x n, per_row uniformly random columns a row (bench/matrices.
    scattered_wide). long_row=(row, lo, hi) also gives row `row` every
    column of [lo, hi): its binned chunk in the stripe holding them needs
    many sub-tiles, so that stripe has a split chunk."""
    mat = scattered_wide(m, n, per_row, seed)
    if long_row is None:
        return mat
    row, lo, hi = long_row
    rows = np.repeat(np.arange(m), np.diff(mat.indptr))
    cols = np.arange(lo, hi)
    vals = np.random.default_rng(seed).standard_normal(cols.size)
    return CSRMatrix.from_coo(
        np.concatenate([rows, np.full(cols.size, row)]),
        np.concatenate([mat.indices, cols]),
        np.concatenate([mat.data, vals.astype(np.float32)]), mat.shape,
    )


def _jumping(chunks=48, seed=2):
    """random_banded(128 * chunks, 90, 11) with its 128-row chunks in a
    random order (rows only): consecutive chunks read far-apart x
    blocks, so step ranges jump, backwards too."""
    mat = random_banded(128 * chunks, 90, 11, seed=1)
    perm = np.random.default_rng(seed).permutation(chunks)
    rows = np.repeat(np.arange(mat.m), np.diff(mat.indptr))
    return CSRMatrix.from_coo(perm[rows // 128] * 128 + rows % 128,
                              mat.indices, mat.data, mat.shape)


def diagonal_matrix(n, offsets, seed=0):
    """An n x n matrix with a standard normal value on every entry of the
    given diagonals (col - row = offset) that lies inside the matrix."""
    rows, cols = [], []
    for off in offsets:
        r = np.arange(max(0, -off), min(n, n - off))
        rows.append(r)
        cols.append(r + off)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = np.random.default_rng(seed).standard_normal(rows.size)
    return CSRMatrix.from_coo(rows, cols, vals.astype(np.float32), (n, n))


# Diagonal structures for the DIA kernels: offsets with no multiple of 4,
# positive offsets only, negative only; n not a multiple of 128.
DIAGONALS = {
    "odd_offsets": (3001, (-131, -7, -1, 3, 9, 250)),
    "positive_only": (2085, (1, 2, 5, 130)),
    "negative_only": (2085, (-300, -3, -1)),
}


def _fit(lay, batch):
    """The layout with its window table cut at fewer sub-tiles a step
    until the ring and stages, batch columns wide, fit the card's shared
    memory (tools/spmv.fit_window's first remedy)."""
    while window_bytes(lay, batch) > hw.smem_per_block():
        lay = lay.with_steps(lay.step_subtiles // 2)
    return lay


def _run(kernel, plain, layout, mat, oracle, dev, batch=None, twin=None,
         twin_equal=False):
    """kernel vs plain and the oracle; with twin (the resident kernel of
    a windowed one), kernel vs twin on the same layout as well, bit for
    bit with twin_equal."""
    lay = layout.to(dev)
    shape = (mat.n,) if batch is None else (mat.n, batch)
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    xt = torch.from_numpy(x).to(dev)
    before = kernel.launches
    yk = kernel(lay, xt)
    yp = plain(lay, xt)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert yk.shape == yp.shape == (mat.m, *shape[1:])
    scale = max(1.0, float(yp.abs().max()))
    assert float((yk - yp).abs().max()) <= 1e-5 * scale
    y = yk.cpu().numpy().reshape(mat.m, -1)
    xs = x.reshape(mat.n, -1)
    for b in range(xs.shape[1]):
        wrong, rel = validate(y[:, b], oracle.matvec(xs[:, b]))
        assert wrong == 0 and rel <= 1e-6, (b, wrong, rel)
    if twin is not None:
        y_twin = twin(lay, xt)
        if twin_equal:
            assert torch.equal(yk, y_twin)
        assert float((yk - y_twin).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("mat", [laplacian_2d(70), variable_stencil(53)],
                         ids=["lap2d", "varstencil"])
@pytest.mark.parametrize("vdt", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_dia_kernel_matches_plain(cuda, mat, vdt):
    lay = DiaSlabs.from_csr(mat, val_dtype=vdt)
    oracle = mat.rounded() if vdt else mat
    _run(spmv_dia, spmv_dia_reference, lay, mat, oracle, cuda)


_RANKED = {
    "banded_grouped": (lambda: _rcm(random_banded(3000, 90, 11, seed=1)), {}),
    "banded_ungrouped": (lambda: _rcm(random_banded(3000, 90, 11, seed=1)),
                         dict(allow_groups=False)),
    "banded_bf16": (lambda: _rcm(random_banded(3000, 90, 11, seed=1)),
                    dict(val_dtype=torch.bfloat16)),
    "general_binned_w4": (lambda: _rcm(random_general(2500, 6, seed=2)),
                          dict(bin_blocks=4)),
    "lap2d_u8_ungrouped": (lambda: _rcm(laplacian_2d(60)),
                           dict(allow_groups=False)),
    "general_i32_lcols": (lambda: random_general(50000, 6, seed=1),
                          dict(align=False)),
    "long_row_grouped": (_long_row, {}),
    "long_row_delta": (_long_row, dict(allow_groups=False)),
    "long_row_bf16_grouped": (_long_row, dict(val_dtype=torch.bfloat16)),
    "long_row_bf16_delta": (_long_row, dict(val_dtype=torch.bfloat16,
                                            allow_groups=False)),
}


@pytest.mark.parametrize("case", sorted(_RANKED))
def test_ranked_kernel_matches_plain(cuda, case):
    make, kw = _RANKED[case]
    mat = make()
    lay = RankedSlabs.from_csr(mat, **kw)
    if case.startswith("long_row"):
        assert lay.split_seg.shape[1] >= 1
    oracle = mat.rounded() if kw.get("val_dtype") else mat
    _run(spmv_ranked, spmv_ranked_reference, lay, mat, oracle, cuda)


@pytest.mark.parametrize("case", ["lap2d_u8_ungrouped", "long_row_grouped",
                                  "long_row_bf16_delta"])
def test_ranked_accumulates_into_out(cuda, case):
    """spmv_ranked(out=y) adds A @ x into y, the fix-up of a split chunk
    too: y0 + acc, the bits of y0 plus a storing call's result, and
    within 1e-5 of y0 plus the plain version. One count a call."""
    make, kw = _RANKED[case]
    mat = make()
    lay = RankedSlabs.from_csr(mat, **kw).to(cuda)
    assert (lay.split_seg.shape[1] >= 1) == case.startswith("long_row")
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal(mat.n).astype(np.float32)).to(cuda)
    y0 = torch.from_numpy(rng.standard_normal(mat.m).astype(np.float32)).to(cuda)
    out = y0.clone()
    before = spmv_ranked.launches
    assert spmv_ranked(lay, x, out=out) is out
    assert spmv_ranked.launches == before + 1
    assert torch.equal(out, y0 + spmv_ranked(lay, x))
    plain = y0 + spmv_ranked_reference(lay, x)
    scale = max(1.0, float(plain.abs().max()))
    assert float((out - plain).abs().max()) <= 1e-5 * scale


def test_striped_kernel_matches_plain_and_replays(cuda):
    """spmv_striped on stripes of 1024 columns, a split chunk in stripe 1
    only: against its plain version and the oracle, one count a call
    (spmv_ranked one a stripe), and two replays of a captured call and an
    eager call give the same bits."""
    mat = _wide(long_row=(5, 1024, 2048))
    lay = StripedRanked.from_csr(mat, stripe_cols=1024, bin_blocks=2,
                                 device=cuda)
    assert lay.num_stripes == 8
    assert [s.split_seg.shape[1] > 0 for s in lay.stripes[:2]] == [False, True]
    before = spmv_ranked.launches
    _run(spmv_striped, spmv_striped_reference, lay, mat, mat, cuda)
    assert spmv_ranked.launches == before + 8
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        mat.n).astype(np.float32)).to(cuda)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = spmv_striped(lay, x)
    graph.replay()
    y1 = out.clone()
    graph.replay()
    expect = spmv_striped(lay, x)
    torch.cuda.synchronize()
    assert torch.equal(y1, out) and torch.equal(y1, expect)


def test_striped_bf16_kernel_matches_plain_and_replays(cuda):
    """bf16 stripes (the route tools.spmv --val-dtype bf16 takes where the
    card's calibration times them faster): spmv_striped on stripes of
    1024 columns against its plain version and the bf16-rounded oracle,
    and two replays of a captured call give the same bits."""
    mat = _wide()
    lay = StripedRanked.from_csr(mat, stripe_cols=1024, bin_blocks=2,
                                 val_dtype=torch.bfloat16, device=cuda)
    assert lay.num_stripes == 8 and lay.val_dtype == torch.bfloat16
    _run(spmv_striped, spmv_striped_reference, lay, mat, mat.rounded(), cuda)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        mat.n).astype(np.float32)).to(cuda)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = spmv_striped(lay, x)
    graph.replay()
    y1 = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y1, out)


_SELL = {
    "general": (lambda: _rcm(random_general(2500, 6, seed=2)), 0),
    "general_binned_w4": (lambda: _rcm(random_general(2500, 6, seed=2)), 4),
    "long_row": (_long_row, 0),
}


@pytest.mark.parametrize("case", sorted(_SELL))
def test_sell_kernel_matches_plain(cuda, case):
    make, bins = _SELL[case]
    mat = make()
    lay = SellSlabs.from_csr(mat, bin_blocks=bins)
    if case == "long_row":
        assert lay.split_seg.shape[1] >= 1
    _run(spmv_sell, spmv_sell_reference, lay, mat, mat, cuda)


_WALKS = {
    "ranked_grouped": (spmv_ranked, lambda m: RankedSlabs.from_csr(m)),
    "ranked_bf16_delta": (spmv_ranked, lambda m: RankedSlabs.from_csr(
        m, val_dtype=torch.bfloat16, allow_groups=False)),
    "sell": (spmv_sell, lambda m: SellSlabs.from_csr(m)),
}


@pytest.mark.parametrize("case", sorted(_WALKS))
def test_segment_walk_replays_bit_identical(cuda, case):
    """Two replays of a captured call on a layout with a split chunk give
    the same bits, and so does an eager call: the fix-up adds a split
    chunk's partials in segment order, with no atomics."""
    fn, build = _WALKS[case]
    mat = _long_row()
    lay = build(mat).to(cuda)
    assert lay.split_seg.shape[1] >= 1
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        mat.n).astype(np.float32)).to(cuda)
    fn(lay, x)  # eager first: builds the library
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(lay, x)
    before = fn.launches
    graph.replay()
    y1 = out.clone()
    graph.replay()
    y2 = out.clone()
    expect = fn(lay, x)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(y1, expect)
    assert fn.launches == before + 1  # the eager call only


@pytest.mark.parametrize("q", [1, 16])
@pytest.mark.parametrize("case", sorted(_WALKS))
def test_segment_walk_at_any_segment_length(cuda, case, q, monkeypatch):
    """Tables cut at 1 sub-tile a segment (every chunk of several
    sub-tiles split) and at 16, the most whose bases a block stages,
    match the plain version."""
    from tpu_spmv_torch.formats import sell as fsell

    fn, build = _WALKS[case]
    mat = _long_row()
    lay = build(mat)
    monkeypatch.setattr(fsell, "SEGMENT_SUBTILES", q)
    lay = fsell.with_segments(lay)
    assert int(lay.seg_ptr.diff().max()) == q
    plain = spmv_sell_reference if fn is spmv_sell else spmv_ranked_reference
    oracle = mat.rounded() if lay.vals.dtype == torch.bfloat16 else mat
    _run(fn, plain, lay, mat, oracle, cuda)


def test_segment_walk_refuses_a_layout_without_a_table(cuda):
    mat = _long_row()
    lay = RankedSlabs.from_csr(mat).to(cuda)
    x = torch.zeros(mat.n, device=cuda)
    before = spmv_ranked.launches
    with pytest.raises(ValueError, match="no segment table"):
        spmv_ranked(dataclasses.replace(lay, seg_ptr=None), x)
    assert spmv_ranked.launches == before


_PACKED = {
    "banded_grouped": (lambda: _rcm(random_banded(3000, 90, 11, seed=1)), {}),
    "banded_delta": (lambda: _rcm(random_banded(3000, 90, 11, seed=1)),
                     dict(allow_groups=False)),
    "banded_bf16": (lambda: _rcm(random_banded(3000, 90, 11, seed=1)),
                    dict(val_dtype=torch.bfloat16)),
    "general_binned_w4": (lambda: _rcm(random_general(2500, 6, seed=2)),
                          dict(bin_blocks=4)),
    "lap2d_u8_delta": (lambda: _rcm(laplacian_2d(60)),
                       dict(allow_groups=False)),
    "long_row_grouped": (_long_row, {}),
    "long_row_bf16_delta": (_long_row, dict(val_dtype=torch.bfloat16,
                                            allow_groups=False)),
}


@pytest.mark.parametrize("case", sorted(_PACKED))
def test_packed_kernel_matches_plain(cuda, case):
    """The long-row cases split a chunk into several segments, whose
    partial rows the fix-up launch adds."""
    make, kw = _PACKED[case]
    mat = make()
    lay = PackedRanked.from_csr(mat, **kw)
    if case.startswith("long_row"):
        assert lay.split_seg.shape[1] >= 1
    oracle = mat.rounded() if kw.get("val_dtype") else mat
    _run(spmv_packed, spmv_packed_reference, lay, mat, oracle, cuda)


@pytest.mark.parametrize("batch", [1, 5, 8, 13])
@pytest.mark.parametrize("case", ["banded_grouped", "banded_bf16",
                                  "general_binned_w4", "lap2d_u8_delta",
                                  "long_row_grouped"])
def test_spmm_kernels_match_plain(cuda, case, batch):
    """Both SpMM kernels on the same matrix; B = 13 takes two column
    tiles, the second one partial; long_row_grouped splits a chunk."""
    make, kw = _PACKED[case]
    mat = make()
    oracle = mat.rounded() if kw.get("val_dtype") else mat
    _run(spmm_packed, spmm_packed_reference, PackedRanked.from_csr(mat, **kw),
         mat, oracle, cuda, batch)
    _run(spmm_ranked, spmm_ranked_reference, RankedSlabs.from_csr(mat, **kw),
         mat, oracle, cuda, batch)


@pytest.mark.parametrize("batch", [None, 5, 8])
def test_packed_walk_replays_bit_identical(cuda, batch):
    """Two replays of a captured spmv_packed (batch None) or spmm_packed
    call on a layout with a split chunk give the same bits, and so does
    an eager call: the fix-up adds the partial rows in segment order."""
    mat = _long_row()
    lay = PackedRanked.from_csr(mat).to(cuda)
    assert lay.split_seg.shape[1] >= 1
    fn = spmv_packed if batch is None else spmm_packed
    shape = (mat.n,) if batch is None else (mat.n, batch)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        shape).astype(np.float32)).to(cuda)
    fn(lay, x)  # eager first: builds the library
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(lay, x)
    before = fn.launches
    graph.replay()
    y1 = out.clone()
    graph.replay()
    y2 = out.clone()
    expect = fn(lay, x)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(y1, expect)
    assert fn.launches == before + 1  # the eager call only


@pytest.mark.parametrize("batch", [5, 8])
def test_spmm_ranked_replays_bit_identical(cuda, batch):
    """Two replays of a captured spmm_ranked call on a layout with a split
    chunk give the same bits, and so does an eager call: the run walk's
    fix-up adds the partial rows in segment order."""
    mat = _long_row()
    lay = RankedSlabs.from_csr(mat).to(cuda)
    assert lay.split_seg.shape[1] >= 1
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (mat.n, batch)).astype(np.float32)).to(cuda)
    spmm_ranked(lay, x)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = spmm_ranked(lay, x)
    before = spmm_ranked.launches
    graph.replay()
    y1 = out.clone()
    graph.replay()
    y2 = out.clone()
    expect = spmm_ranked(lay, x)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(y1, expect)
    assert spmm_ranked.launches == before + 1  # the eager call only


@pytest.mark.parametrize("batch", [5, 13])
@pytest.mark.parametrize("q", [1, 16])
def test_spmm_ranked_walk_at_any_segment_length(cuda, q, batch, monkeypatch):
    """Ranked tables cut at 1 sub-tile a segment (every chunk of several
    sub-tiles split) and at 16, with their runs cut anew, match the plain
    version, ungrouped with int16 columns too."""
    from tpu_spmv_torch.formats import sell as fsell

    mat = _long_row()
    monkeypatch.setattr(fsell, "SEGMENT_SUBTILES", q)
    for kw in ({}, dict(allow_groups=False)):
        lay = fsell.with_segments(RankedSlabs.from_csr(mat, **kw))
        _run(spmm_ranked, spmm_ranked_reference, lay, mat, mat, cuda, batch)


@pytest.mark.parametrize("batch", [None, 5])
@pytest.mark.parametrize("q", [1, 16])
def test_packed_walk_at_any_segment_length(cuda, q, batch, monkeypatch):
    """Packed tables cut at 1 sub-tile a segment (every chunk that
    touches two sub-tiles split) and at 16, the most whose bases a block
    stages, match the plain version."""
    from tpu_spmv_torch.formats import packed as fpacked
    from tpu_spmv_torch.formats import sell as fsell

    mat = _long_row()
    monkeypatch.setattr(fsell, "SEGMENT_SUBTILES", q)
    lay = fpacked.with_segments(PackedRanked.from_csr(mat))
    fn, plain = ((spmv_packed, spmv_packed_reference) if batch is None
                 else (spmm_packed, spmm_packed_reference))
    _run(fn, plain, lay, mat, mat, cuda, batch)


@pytest.mark.parametrize("mat", [
    laplacian_2d(300), variable_stencil(97),
    *(diagonal_matrix(n, offs) for n, offs in DIAGONALS.values()),
], ids=["lap2d", "varstencil", *DIAGONALS])
@pytest.mark.parametrize("vdt", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_dia_windowed_kernel_matches_plain(cuda, mat, vdt):
    """Many steps over the ring, each adding its rows of x; spmv_dia's
    bits on the same layout. The DIAGONALS cases: offsets with no
    multiple of 4, positive or negative only, n not a multiple of 128."""
    lay = DiaSlabs.from_csr(mat, val_dtype=vdt, rows_per_tile=8192)
    oracle = mat.rounded() if vdt else mat
    _run(spmv_dia_windowed, spmv_dia_windowed_reference, lay, mat, oracle,
         cuda, twin=spmv_dia, twin_equal=True)


@pytest.mark.parametrize("vdt", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_dia_windowed_ring_wraps(cuda, vdt, monkeypatch):
    """Steps of 128 rows over 640,000: every CTA writes more of x than
    its ring holds, so the ring wraps; spmv_dia's bits still."""
    from tpu_spmv_torch.kernels import dia as kdia

    monkeypatch.setattr(kdia, "DIA_STEP_ROWS", 128)
    mat = laplacian_2d(800)
    lay = DiaSlabs.from_csr(mat, val_dtype=vdt).to(cuda)
    ring = kdia.dia_ring(lay, kdia.dia_smem_budget(cuda))
    steps = -(-mat.m // ring.step_rows)
    assert ring.step_rows == 128
    span = max(lay.offsets) - min(lay.offsets)
    per_cta = steps // kdia.dia_windowed_ctas(lay, ring)
    assert per_cta * ring.step_rows + span > ring.ring
    oracle = mat.rounded() if vdt else mat
    _run(spmv_dia_windowed, spmv_dia_windowed_reference, lay, mat, oracle,
         cuda, twin=spmv_dia, twin_equal=True)


def test_dia_windowed_replays_bit_identical(cuda):
    """Two replays of a captured spmv_dia_windowed call give the same bits
    as each other and as an eager call (the mbarriers are set up in every
    launch)."""
    n, offs = DIAGONALS["odd_offsets"]
    mat = diagonal_matrix(n * 40, offs)
    lay = DiaSlabs.from_csr(mat).to(cuda)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        mat.n).astype(np.float32)).to(cuda)
    spmv_dia_windowed(lay, x)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = spmv_dia_windowed(lay, x)
    graph.replay()
    y1 = out.clone()
    graph.replay()
    y2 = out.clone()
    expect = spmv_dia_windowed(lay, x)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(y1, expect)
    assert torch.equal(y1, spmv_dia(lay, x))


_WINDOWED = {
    "banded_grouped": (lambda: _rcm(random_banded(20000, 90, 11, seed=1)),
                       dict(tile_k=512)),
    "banded_bf16_ungrouped": (
        lambda: _rcm(random_banded(20000, 90, 11, seed=1)),
        dict(tile_k=1024, allow_groups=False, val_dtype=torch.bfloat16)),
    "lap2d_u8": (lambda: _rcm(laplacian_2d(200)), dict(tile_k=512)),
}


@pytest.mark.parametrize("case,batch", [
    (case, batch) for case in sorted(_WINDOWED)
    for batch in (None, 1, 5, 8, 13)
])
def test_ranked_windowed_kernels_match_plain(cuda, case, batch):
    """spmv_ranked_windowed (batch None) and spmm_ranked_windowed against
    their plain versions and their resident twins (spmv_ranked bit for
    bit); B = 13 takes two column groups, 8 and 5."""
    make, kw = _WINDOWED[case]
    mat = make()
    lay = _fit(RankedSlabs.from_csr(mat, **kw), batch or 1)
    assert lay.step_lo.numel() > 1
    oracle = mat.rounded() if kw.get("val_dtype") else mat
    if batch is None:
        _run(spmv_ranked_windowed, spmv_ranked_windowed_reference, lay, mat,
             oracle, cuda, twin=spmv_ranked, twin_equal=True)
    else:
        _run(spmm_ranked_windowed, spmm_ranked_windowed_reference, lay, mat,
             oracle, cuda, batch, twin=spmm_ranked)


@pytest.mark.parametrize("case", ["split_chunk", "jumping", "lap2d_steps_2"])
def test_ranked_windowed_equals_ranked_bit_for_bit(cuda, case):
    """spmv_ranked_windowed gives spmv_ranked's bits on one layout: with a
    split chunk (the fix-up launch), on step ranges that jump backwards
    past the ring (the restage path), and on a ring that wraps."""
    if case == "split_chunk":
        mat = _long_row()
        lay = RankedSlabs.from_csr(mat)
        assert lay.split_seg.shape[1] > 0
    elif case == "jumping":
        mat = _jumping()
        lay = RankedSlabs.from_csr(mat).with_steps(1)
        lo, hi = lay.step_lo.long(), lay.step_hi.long()
        assert bool((lo.diff() < 0).any())
        span = torch.maximum(hi[1:], hi[:-1]) - torch.minimum(lo[1:], lo[:-1])
        assert bool((span > lay.ring_blocks).any())  # restaged steps
    else:
        mat = _rcm(laplacian_2d(200))
        lay = RankedSlabs.from_csr(mat).with_steps(2)
    lo, hi = lay.step_lo.long(), lay.step_hi.long()
    R = lay.ring_blocks
    assert bool((lo // R != (hi - 1) // R).any())  # a step wraps the ring
    _run(spmv_ranked_windowed, spmv_ranked_windowed_reference, lay, mat,
         mat, cuda, twin=spmv_ranked, twin_equal=True)
    _run(spmm_ranked_windowed, spmm_ranked_windowed_reference, _fit(lay, 5),
         mat, mat, cuda, 5, twin=spmm_ranked)


def test_windowed_kernels_refuse_an_unaligned_x(cuda):
    mat = _rcm(laplacian_2d(40))
    lay = RankedSlabs.from_csr(mat).to(cuda)
    x = torch.zeros(mat.n + 1, device=cuda)[1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        spmv_ranked_windowed(lay, x)


def test_dia_windowed_refuses_unaligned_values(cuda):
    """A step's values are bulk-copied, so vals must be 16-byte aligned:
    a view at an odd offset is refused before any launch."""
    lay = DiaSlabs.from_csr(laplacian_2d(40)).to(cuda)
    flat = torch.zeros(lay.vals.numel() + 1, device=cuda)
    flat[1:].copy_(lay.vals.reshape(-1))
    odd = dataclasses.replace(lay, vals=flat[1:].view(lay.vals.shape))
    before = spmv_dia_windowed.launches
    with pytest.raises(ValueError, match="vals must be 16-byte aligned"):
        spmv_dia_windowed(odd, torch.zeros(lay.n, device=cuda))
    assert spmv_dia_windowed.launches == before


def test_dia_ring_shared_memory_is_the_kernels(cuda):
    """The host sizing and the kernel agree on the ring's shared memory:
    the budget leaves room for the kernel's static bytes, and a launch
    whose size is not the ring, two stages and the offsets is refused."""
    from tpu_spmv_torch.kernels import _build
    from tpu_spmv_torch.kernels import dia as kdia

    static = _build.library().tsp_dia_windowed_static_smem()
    assert static > 0
    assert kdia.dia_smem_budget(cuda) == hw.smem_per_block(cuda) - static
    lay = DiaSlabs.from_csr(laplacian_2d(300)).to(cuda)
    ring = kdia.dia_ring(lay, kdia.dia_smem_budget(cuda))
    assert kdia.dia_windowed_ctas(lay, ring) >= 1
    for wrong in (ring.smem + ring.stage_bytes, ring.smem - 4):
        bad = dataclasses.replace(ring, smem=wrong)
        with pytest.raises(RuntimeError):
            kdia.dia_windowed_ctas(lay, bad)


def test_windowed_kernels_replay_from_a_graph(cuda):
    """One captured call of each windowed kernel, replayed on new x,
    equals an eager call (the partials buffer and the shared-memory
    opt-in are no host work inside the capture)."""
    mat = _rcm(random_banded(20000, 90, 11, seed=1))
    ranked = RankedSlabs.from_csr(mat, tile_k=512).to(cuda)
    dia = DiaSlabs.from_csr(laplacian_2d(300)).to(cuda)
    rng = np.random.default_rng(5)
    for fn, lay, shape in ((spmv_ranked_windowed, ranked, (mat.n,)),
                           (spmm_ranked_windowed, ranked, (mat.n, 5)),
                           (spmv_dia_windowed, dia, (dia.n,))):
        static_x = torch.zeros(shape, device=cuda)
        fn(lay, static_x)  # eager first: builds, opts into shared memory
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn(lay, static_x)
        before = fn.launches
        for _ in range(2):
            static_x.copy_(torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32)).to(cuda))
            graph.replay()
            expect = fn(lay, static_x)
            torch.cuda.synchronize()
            assert torch.equal(out, expect)
        assert fn.launches == before + 2  # the eager calls only


def test_windowed_plain_version_times_from_a_graph(cuda):
    """chip_smoke times each plain version from a CUDA graph
    (bench/harness.bench_spmv): the windowed one does no host sync, so
    its launches capture."""
    mat = _rcm(random_banded(20000, 90, 11, seed=1))
    lay = RankedSlabs.from_csr(mat).to(cuda)
    x = torch.ones(mat.n, device=cuda)
    res = bench_spmv(spmv_ranked_windowed_reference, lay, x, samples=2)
    assert res.launch == "graph" and 0 < res.time_min <= res.time_max


def test_windowed_kernels_refuse_an_oversize_window(cuda, monkeypatch):
    mat = _rcm(random_banded(20000, 90, 11, seed=1))
    ranked = RankedSlabs.from_csr(mat, tile_k=512).to(cuda)
    dia = DiaSlabs.from_csr(laplacian_2d(300)).to(cuda)
    monkeypatch.setattr(hw, "smem_per_block", lambda device=None: 1024)
    x = torch.zeros(mat.n, device=cuda)
    before = (spmv_ranked_windowed.launches, spmm_ranked_windowed.launches,
              spmv_dia_windowed.launches)
    need = window_bytes(ranked, 1)
    with pytest.raises(ValueError, match=f"= {need} bytes, beyond the 1024"):
        spmv_ranked_windowed(ranked, x)
    with pytest.raises(ValueError, match="shared-memory budget"):
        spmm_ranked_windowed(ranked, torch.zeros(mat.n, 2, device=cuda))
    with pytest.raises(ValueError, match="shared-memory budget"):
        spmv_dia_windowed(dia, torch.zeros(dia.n, device=cuda))
    assert (spmv_ranked_windowed.launches, spmm_ranked_windowed.launches,
            spmv_dia_windowed.launches) == before


def test_wrapper_refuses_bad_operands(cuda):
    mat = laplacian_2d(20)
    lay = DiaSlabs.from_csr(mat).to(cuda)
    with pytest.raises(ValueError):
        spmv_dia(lay, torch.zeros(mat.n, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        spmv_dia(DiaSlabs.from_csr(mat), torch.zeros(mat.n, device=cuda))
    packed = PackedRanked.from_csr(mat).to(cuda)
    with pytest.raises(ValueError):
        spmm_packed(packed, torch.zeros(mat.n, device=cuda))  # not (n, B)
    with pytest.raises(ValueError):
        spmm_packed(packed, torch.zeros(4, mat.n, device=cuda).t())
    with pytest.raises(ValueError):
        spmv_packed(packed, torch.zeros(mat.n, 1, device=cuda))


def test_timing_on_card(cuda):
    mat = laplacian_2d(64)
    lay = DiaSlabs.from_csr(mat).to(cuda)
    x = torch.ones(mat.n, device=cuda)
    warm = bench_spmv(spmv_dia, lay, x, samples=2)
    # A tiny operator: pretend L2 holds one copy, so K stays small.
    cold = bench_spmv_cold(spmv_dia, lay.clone, x, nnz=mat.nnz,
                           layout_bytes=lay.nbytes, l2_bytes=lay.nbytes,
                           samples=2)
    assert warm.regime == "warm" and cold.regime == "cold"
    assert 0 < warm.time_min <= warm.time_avg <= warm.time_max
    assert cold.iters[2] == 4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


_SOLVES = {
    "lap2d_LS": (lambda: laplacian_2d(60), dict(order_type="LS")),
    "lap2d_COLOR": (lambda: laplacian_2d(60), dict(order_type="COLOR")),
    "banded_LS_binned": (lambda: random_banded(1536, 200, 8, seed=0),
                         dict(order_type="LS")),
    "banded_LS_k3": (lambda: random_banded(3000, 90, 11, seed=1),
                     dict(order_type="LS", k=3, sup_row_sizes=(8,))),
    "general_COLOR": (lambda: random_general(2500, 6, seed=2),
                      dict(order_type="COLOR")),
}


def arrow_lower(n=3000, dense=3, seed=0):
    """The lower triangle of random_banded(n, 20, 5) with its last
    `dense` rows made full (diagonal 4, the rest 0.001). In level order
    with sort_packs=False, which keeps a triangular input, each full
    row's chunk holds about n / 8 sub-tiles (375 at n = 3000) and waits
    on up to 530 chunks."""
    lower, _ = split_lu(random_banded(n, 20, 5, seed=seed))
    rows = np.repeat(np.arange(n), np.diff(lower.indptr))
    keep = rows < n - dense
    full = np.arange(n - dense, n)
    R = np.concatenate([np.full(d + 1, d) for d in full])
    C = np.concatenate([np.arange(d + 1) for d in full])
    return CSRMatrix.from_coo(
        np.concatenate([rows[keep], R]),
        np.concatenate([lower.indices[keep], C]),
        np.concatenate([lower.data[keep],
                        np.where(R == C, 4.0, 0.001).astype(np.float32)]),
        (n, n),
    )


def _built(sys_, b, ranked):
    """LowerSolveLayout.build(sys_, b, ranked=ranked) with lower_solve
    held to the kernel _solve_pair names (the ranked one whenever it is
    built), whatever the card's calibration chooses."""
    lay = LowerSolveLayout.build(sys_, b, ranked=ranked)
    return dataclasses.replace(lay, solve="ranked")


def _solve_pair(lay):
    if lay.ranked is not None:
        return (lower_solve_ranked, lower_solve_ranked_reference, lay.ranked,
                lay.ranked_steps)
    return (lower_solve_blocks, lower_solve_blocks_reference, lay.slabs,
            lay.slab_steps)


def _check_solve_kernel(sys_, b, ranked):
    """The solve kernel the layout picks (ranked or blocks) against its
    plain version (bit for bit) and the f64 oracle; returns the layout."""
    lay = LowerSolveLayout.build(sys_, b, ranked=ranked)
    assert lay.b_scale.device.type == "cuda"  # built for the card
    kernel, plain, slabs, steps = _solve_pair(lay)
    assert (kernel is lower_solve_ranked) == ranked
    before = kernel.launches
    xk = kernel(slabs, lay.b_scale)
    xp = plain(slabs, lay.b_scale, steps)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(xk, xp)
    x = xk.reshape(-1)[lay.pad_index].cpu().numpy()
    assert _rel(x, lower_solve_reference(sys_, b)) <= 1e-5
    assert int(np.sum(np.abs(x - 1.0) > 0.01)) == 0
    return lay


@pytest.mark.parametrize("ranked", [True, False], ids=["ranked", "blocks"])
def test_solve_kernels_on_chunks_past_the_prefetch(cuda, ranked):
    """Full rows: chunks of up to 375 sub-tiles (the kernels hold 4
    before their wait and stream the rest) waiting on up to 530 chunks
    (a warp takes them 32 at a time)."""
    sys_ = build_sts(arrow_lower(), order_type="LS", sort_packs=False)
    lay = _check_solve_kernel(sys_, compute_b(sys_.lower), ranked)
    slabs = _solve_pair(lay)[2]
    assert int(slabs.chunk_ptr.diff().max()) > 4
    assert int(slabs.wait_ptr.diff().max()) > 32


@pytest.mark.parametrize("ranked", [True, False], ids=["ranked", "blocks"])
def test_solve_kernels_on_a_chain(cuda, ranked):
    """A bidiagonal chain of 3000 rows: 3000 chunks, each waiting on the
    one before."""
    sys_ = build_sts(bidiagonal_chain(3000), order_type="LS")
    assert sys_.num_packs == 3000
    _check_solve_kernel(sys_, compute_b(sys_.lower), ranked)


def test_solve_kernels_refuse_a_layout_without_a_wait_table(cuda):
    sys_ = build_sts(laplacian_2d(60), order_type="LS")
    lay = LowerSolveLayout.build(sys_, compute_b(sys_.lower))
    for kernel, slabs in ((lower_solve_ranked, lay.ranked),
                          (lower_solve_blocks, lay.slabs)):
        bare = dataclasses.replace(slabs, wait_ptr=None, wait_chunk=None)
        before = kernel.launches
        with pytest.raises(ValueError, match="no wait table"):
            kernel(bare, lay.b_scale)
        assert kernel.launches == before


def test_solve_replays_bit_identical_past_the_prefetch(cuda):
    """Two calls, and three replays of a captured call, on the full-row
    system give the same bits: the streamed sub-tiles too are summed in
    a fixed order."""
    sys_ = build_sts(arrow_lower(), order_type="LS", sort_packs=False)
    b = compute_b(sys_.lower)
    for ranked in (True, False):
        lay = _built(sys_, b, ranked)
        x1, x2 = lower_solve(lay), lower_solve(lay)
        torch.cuda.synchronize()
        assert torch.equal(x1, x2)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = lower_solve(lay)
        for _ in range(3):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, x1)


@pytest.mark.parametrize("ranked", [True, False], ids=["ranked", "blocks"])
@pytest.mark.parametrize("case", sorted(_SOLVES))
def test_solve_kernels_match_plain(cuda, case, ranked):
    """Both solve kernels against their plain versions (bit for bit)
    and the oracle. Every LS system's chunk 0 is all padding (the level-0 rows have no
    strict-L entries), whose slots point at chunk 0 itself."""
    make, kw = _SOLVES[case]
    sys_ = build_sts(make(), **kw)
    b = compute_b(sys_.lower)
    lay = LowerSolveLayout.build(sys_, b, ranked=ranked)
    if case == "banded_LS_binned" and ranked:
        assert lay.ranked is not None and lay.slabs.max_nb > 8
    lay = lay.to(cuda)
    kernel, plain, slabs, steps = _solve_pair(lay)
    assert (kernel is lower_solve_ranked) == ranked
    before = kernel.launches
    xk = kernel(slabs, lay.b_scale)
    xp = plain(slabs, lay.b_scale, steps)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert xk.shape == xp.shape
    assert torch.equal(xk, xp)
    x = xk.reshape(-1)[lay.pad_index].cpu().numpy()
    assert _rel(x, lower_solve_reference(sys_, b)) <= 1e-5
    assert int(np.sum(np.abs(x - 1.0) > 0.01)) == 0


def test_solve_kernels_on_an_all_padding_system(cuda):
    """A diagonal-only matrix: one pack, every chunk all padding."""
    n = 1000
    diag = CSRMatrix.from_coo(np.arange(n), np.arange(n),
                              np.linspace(1, 4, n).astype(np.float32), (n, n))
    sys_ = build_sts(diag, order_type="LS")
    b = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    for ranked in (True, False):
        lay = _built(sys_, b, ranked).to(cuda)
        x = lower_solve(lay).cpu().numpy()
        assert _rel(x, b / diag.data[sys_.perm]) <= 1e-6


def test_solve_flags_reset_between_calls_and_graph_replays(cuda):
    """Each call sets x's chunk rows to the sentinel (an unsolved row is
    its own ready flag) and zeroes the guard rows and the ticket on its
    stream, so back-to-back calls and replays of a captured call (whose
    frozen arguments cannot carry an epoch) all solve afresh: a replay
    that found the last replay's rows would take them as solved, and a
    ticket left at its end would start no chunk."""
    sys_ = build_sts(laplacian_2d(60), order_type="LS")
    b = compute_b(sys_.lower)
    rng = np.random.default_rng(4)
    for ranked in (True, False):
        lay = _built(sys_, b, ranked).to(cuda)
        kernel, plain, slabs, steps = _solve_pair(lay)
        x1, x2 = kernel(slabs, lay.b_scale), kernel(slabs, lay.b_scale)
        torch.cuda.synchronize()
        assert torch.equal(x1, x2)
        assert not (x1.view(torch.int32) == -1).any()  # no row unsolved
        assert not x1[slabs.num_chunks:].any()  # guard rows zero
        static_b = lay.b_scale.clone()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = kernel(slabs, static_b)
        before = kernel.launches
        for _ in range(3):
            new_b = torch.from_numpy(rng.standard_normal(
                tuple(static_b.shape)).astype(np.float32)).to(cuda)
            static_b.copy_(new_b)
            graph.replay()
            expect = kernel(slabs, new_b)
            torch.cuda.synchronize()
            assert torch.equal(out, expect)
            assert torch.equal(out, plain(slabs, new_b, steps))
        assert kernel.launches == before + 3  # the eager calls only


def _hpcg_ic0_systems(n=16):
    """The two solve systems of IC(0) on HPCG's operator on an n^3 grid
    in natural order: L, and the reversed L^T (sts/ic0's schedules)."""
    L, bad = ic0_factor(hpcg27(n))
    assert bad == 0
    sys_l, _, _, sys_u, _ = _ic0_schedules(L)
    return {"lower": sys_l, "upper": sys_u}


@pytest.mark.parametrize("ranked", [True, False], ids=["ranked", "blocks"])
@pytest.mark.parametrize("which", ["lower", "upper"])
def test_solve_kernels_bit_equal_on_hpcg_ic0(cuda, which, ranked):
    """Both kernels give their plain versions' bits on the IC(0) factor
    of HPCG's 27-point grid (16^3: 7 * 15 + 1 levels), the forward and
    the reversed-upper system, for x = ones and a random b."""
    sys_ = _hpcg_ic0_systems()[which]
    assert sys_.num_packs == 106
    lay = _check_solve_kernel(sys_, compute_b(sys_.lower), ranked)
    kernel, plain, slabs, steps = _solve_pair(lay)
    b = torch.from_numpy(np.random.default_rng(5).standard_normal(
        tuple(lay.b_scale.shape)).astype(np.float32)).to(cuda)
    xk = kernel(slabs, b)
    assert torch.equal(xk, plain(slabs, b, steps))
    assert torch.equal(xk, plain(slabs, b))  # chunk by chunk


_NONFINITE_B = textwrap.dedent("""
    import numpy as np, torch
    from tpu_spmv_torch.bench.solve_times import hpcg27_system
    from tpu_spmv_torch.kernels.sts import (
        lower_solve_blocks, lower_solve_blocks_reference,
        lower_solve_ranked, lower_solve_ranked_reference)
    from tpu_spmv_torch.sts.host import compute_b
    from tpu_spmv_torch.sts.solve import LowerSolveLayout

    sys_ = hpcg27_system(8)
    lay = LowerSolveLayout.build(sys_, compute_b(sys_.lower), ranked=True)
    bits = lay.b_scale.clone().view(torch.int32).reshape(-1)
    rows = lay.pad_index[torch.tensor([40, 130, 260, 390])]
    bits[rows] = torch.tensor([0x7FC00000, 0x7F800000, -0x800000, -1],
                              dtype=torch.int32, device=bits.device)
    b = bits.view(torch.float32).view(lay.b_scale.shape)
    for kernel, plain, slabs in (
            (lower_solve_ranked, lower_solve_ranked_reference, lay.ranked),
            (lower_solve_blocks, lower_solve_blocks_reference, lay.slabs)):
        xk = kernel(slabs, b)
        xp = plain(slabs, b)
        torch.cuda.synchronize()
        assert not (xk.view(torch.int32) == -1).any(), "a row reads unsolved"
        for test in (torch.isnan, torch.isposinf, torch.isneginf):
            assert torch.equal(test(xk), test(xp)), test.__name__
        fin = torch.isfinite(xp)
        assert torch.equal(xk[fin], xp[fin])
        print(kernel.__name__, "nan", int(torch.isnan(xk).sum()), "inf",
              int(torch.isinf(xk).sum()), "finite", int(fin.sum()))
    print("OK")
""")


def test_solve_kernels_take_nan_inf_and_the_sentinel_in_b(cuda):
    """A b holding NaN, +inf, -inf and the sentinel's own bits
    (0xFFFFFFFF) at some rows of HPCG's 27-point IC(0) factor (8^3):
    both kernels return, no row of x reads the sentinel, and the NaN and
    inf positions and the finite bits are the plain versions'. Run in a
    process of its own under a watchdog: a row that read as unsolved
    forever would hang its consumers, and a hung kernel is killed with
    its process."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root, os.environ.get("PYTHONPATH", "")]))
    try:
        done = subprocess.run([sys.executable, "-c", _NONFINITE_B], cwd=root,
                              env=env, capture_output=True, text=True,
                              timeout=600)
    except subprocess.TimeoutExpired:
        pytest.fail("the solve did not return within 600 s: a row stayed "
                    "unsolved")
    assert done.returncode == 0, done.stdout + done.stderr
    assert done.stdout.strip().endswith("OK"), done.stdout


def test_ic0_apply_and_pcg_on_card(cuda):
    """apply with the kernels against apply with the plain versions, and
    PCG from a captured iteration against the eager loop."""
    mat = _rcm(laplacian_2d(48))
    pre = IC0Preconditioner.build(mat).to(cuda)
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(
        mat.m).astype(np.float32)).to(cuda)
    assert _rel(pre.apply(r).cpu(), pre.apply(r, plain=True).cpu()) <= 1e-5
    lay = RankedSlabs.from_csr(mat).to(cuda)
    b = torch.ones(mat.m, device=cuda)
    x_eager, _ = pcg_ic0_solve(lay, b, pre, iters=30)
    state = pcg_ic0_init(b, pre)
    graph = capture_pcg_step(lay, pre, state)
    for _ in range(30):
        graph.replay()
    torch.cuda.synchronize()
    assert _rel(state[0].cpu(), x_eager.cpu()) <= 1e-5
    x = state[0].cpu().numpy()
    # 0.17 after 10 iterations, 6e-5 after 30 (plain versions, CPU).
    resid = np.linalg.norm(mat.matvec(x) - 1.0) / np.sqrt(mat.m)
    assert resid < 1e-3


def test_calibration_measures_on_card(cuda):
    """tools.tune's protocol on the card at a small scale: every constant
    measured, none below 0, and the shipped table's entry for this card
    (if it has one) holds the same constants."""
    import json

    from tpu_spmv_torch.tools import tune

    points = tune.measure_points(scale=0.25, device="cuda")
    assert len(points["sell"]) == len(tune.SPANS)
    assert len(points["ranked"]) == len(tune.RANKED_WIDTHS)
    consts = tune.fit(points)
    assert tuple(consts) == tune.KEYS
    assert consts["unit_ns"] > 0 and min(consts.values()) >= 0.0
    with open(hw.SHIPPED_CALIB) as f:
        entry = json.load(f).get(hw.device_kind())
    if entry is not None:
        assert set(entry) == set(consts)


@pytest.mark.parametrize("kind", ["sell", "ranked", "packed"])
def test_cached_layout_gives_the_built_layouts_bits(cuda, kind, tmp_path):
    """A layout saved and loaded (formats/sell.save_layout, load_layout)
    gives the bits of the layout it was saved from, on the card."""
    from tpu_spmv_torch.formats.sell import load_layout

    mat = _rcm(random_banded(20_000, 300, 12, seed=3))
    cls, fn = {"sell": (SellSlabs, spmv_sell),
               "ranked": (RankedSlabs, spmv_ranked),
               "packed": (PackedRanked, spmv_packed)}[kind]
    built = cls.from_csr(mat)
    path = tmp_path / "lay.npz"
    built.save(path, matrix=mat, config=(0, 0, 1))
    loaded = load_layout(path, matrix=mat, config=(0, 0, 1))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        mat.n).astype(np.float32)).to(cuda)
    assert torch.equal(fn(built.to(cuda), x), fn(loaded.to(cuda), x))


# The distributed layer (tpu_spmv_torch.dist): D shards on the one card,
# each with its own streams, every sharded call held to the same call
# through the kernels' plain versions and to the oracle.

def _dist_case(cuda, mat, D, cls="ranked", **kw):
    from tpu_spmv_torch.dist import sharding as dsh

    mesh = dsh.make_row_mesh([cuda] * D)
    build = {"ranked": dsh.ShardedRanked, "sell": dsh.ShardedSell,
             "overlap": dsh.OverlapRanked}[cls]
    return dsh, mesh, build.build(mat, D, **kw).device_put(mesh)


def _dist_check(dsh, call, lay, mesh, mat, X):
    """kernel vs plain (1e-5 * max(1, max |y|)) and the oracle."""
    Xs = dsh.shard_vector(X, mesh, lay.padded_m)
    yk = dsh.gather_vector(call(lay, Xs, mesh))[: mat.m]
    yp = dsh.gather_vector(call(lay, Xs, mesh, plain=True))[: mat.m]
    assert np.abs(yk - yp).max() <= 1e-5 * max(1.0, np.abs(yp).max())
    Xc = X.reshape(mat.n, -1)
    ref = np.stack([mat.matvec(Xc[:, b]) for b in range(Xc.shape[1])], 1)
    wrong, rel = validate(yk.reshape(mat.m, -1), ref)
    assert wrong == 0 and rel <= 1e-6, (wrong, rel)
    return yk


@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("cls", ["ranked", "sell"])
def test_sharded_spmv_on_one_card(cuda, D, cls):
    from tpu_spmv_torch.kernels.sell import spmv_ranked, spmv_sell

    mat = _rcm(laplacian_2d(100))
    dsh, mesh, lay = _dist_case(cuda, mat, D, cls)
    kernel = spmv_ranked if cls == "ranked" else spmv_sell
    before = kernel.launches
    x = np.random.default_rng(0).standard_normal(mat.n).astype(np.float32)
    y = _dist_check(dsh, dsh.spmv_sharded, lay, mesh, mat, x)
    assert kernel.launches - before == D
    if D == 1 and cls == "ranked":
        # One shard, no halo: spmv_ranked's bits on the shard's layout.
        one = spmv_ranked(lay.shards[0], dsh.shard_vector(
            x, mesh, lay.padded_m)[0][: mat.n])[: mat.m]
        assert np.array_equal(y, one.cpu().numpy())


def test_sharded_spmv_allgather_on_one_card(cuda):
    mat = _rcm(laplacian_2d(100))
    dsh, mesh, lay = _dist_case(cuda, mat, 4, halo="never")
    assert lay.halo == 0
    x = np.random.default_rng(1).standard_normal(mat.n).astype(np.float32)
    _dist_check(dsh, dsh.spmv_sharded, lay, mesh, mat, x)


def test_overlap_on_one_card(cuda):
    mat = random_banded(8000, 50, 8, seed=2)
    dsh, mesh, lay = _dist_case(cuda, mat, 4, "overlap")
    assert lay.edge.nnz > 0
    x = np.random.default_rng(2).standard_normal(mat.n).astype(np.float32)
    _dist_check(dsh, dsh.spmv_overlap, lay, mesh, mat, x)
    X = np.random.default_rng(3).standard_normal((mat.n, 3)).astype(
        np.float32)
    _dist_check(dsh, dsh.spmm_overlap, lay, mesh, mat, X)


def test_overlap_with_empty_edges_on_one_card(cuda):
    import scipy.sparse as sp

    blocks = [random_banded(1024, 30, 6, seed=s).to_scipy() for s in range(4)]
    mat = CSRMatrix.from_scipy(sp.block_diag(blocks, format="csr"))
    dsh, mesh, lay = _dist_case(cuda, mat, 4, "overlap")
    assert lay.edge.nnz == 0
    x = np.random.default_rng(4).standard_normal(mat.n).astype(np.float32)
    _dist_check(dsh, dsh.spmv_overlap, lay, mesh, mat, x)


@pytest.mark.parametrize("kernel", ["resident", "windowed", "auto"])
def test_sharded_spmm_on_one_card(cuda, kernel):
    mat = _rcm(laplacian_2d(100))
    dsh, mesh, lay = _dist_case(cuda, mat, 4)
    X = np.random.default_rng(5).standard_normal((mat.n, 5)).astype(
        np.float32)

    def call(lay_, Xs, mesh_, plain=False):
        return dsh.spmm_sharded(lay_, Xs, mesh_, kernel=kernel, plain=plain)

    _dist_check(dsh, call, lay, mesh, mat, X)


def test_sharded_cg_graph_on_one_card(cuda):
    """CG over 4 shards: a captured iteration replayed gives the eager
    loop's x (to 1e-5), and both converge."""
    from tpu_spmv_torch.dist import solvers

    mat = random_banded(8000, 50, 8, seed=1)
    dsh, mesh, lay = _dist_case(cuda, mat, 4)
    b = dsh.shard_vector(np.ones(mat.m, np.float32), mesh, lay.padded_m)
    xg, rzg = solvers.cg_solve(lay, b, mesh, iters=80, graph=True)
    xe, rze = solvers.cg_solve(lay, b, mesh, iters=80, graph=False)
    xg, xe = dsh.gather_vector(xg)[: mat.m], dsh.gather_vector(xe)[: mat.m]
    assert np.linalg.norm(xg - xe) / np.linalg.norm(xe) <= 1e-5
    assert np.linalg.norm(mat.matvec(xg) - 1.0) / np.sqrt(mat.m) < 1e-4
    inv = dsh.shard_vector(solvers.jacobi_inv_diag(mat.diagonal(),
                                                   lay.padded_m), mesh)
    xp, _ = solvers.pcg_solve(lay, b, mesh, inv, iters=80)
    xp = dsh.gather_vector(xp)[: mat.m]
    assert np.linalg.norm(mat.matvec(xp) - 1.0) / np.sqrt(mat.m) < 1e-4


# The sharded triangular solve and the distributed IC(0) preconditioners
# (dist/sts.py, sts/ic0.py): D shards on the one card, kernels against
# plain versions and the f64 oracle (RelL2 <= 1e-5).

def _sts_case(cuda, mat, order, D):
    from tpu_spmv_torch.dist import sharding as dsh
    from tpu_spmv_torch.dist.sts import ShardedLowerSolve

    sys_ = build_sts(mat, order_type=order)
    b = compute_b(sys_.lower)
    lay, pad = ShardedLowerSolve.build(sys_, b, D)
    mesh = dsh.make_row_mesh([cuda] * D)
    return dsh, sys_, b, lay.device_put(mesh), pad, mesh


@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("order", ["LS", "COLOR"])
def test_sharded_solve_on_one_card(cuda, D, order):
    from tpu_spmv_torch.dist.sts import sts_solve_sharded
    from tpu_spmv_torch.kernels.sell import spmv_sell
    from tpu_spmv_torch.kernels.sts import lower_solve_blocks

    mat = _rcm(laplacian_2d(100))
    dsh, sys_, b, lay, pad, mesh = _sts_case(cuda, mat, order, D)
    before = (spmv_sell.launches, lower_solve_blocks.launches)
    xk = dsh.gather_vector(sts_solve_sharded(lay, mesh))
    assert (spmv_sell.launches - before[0],
            lower_solve_blocks.launches - before[1]) == (D, D)
    xp = dsh.gather_vector(sts_solve_sharded(lay, mesh, plain=True))
    assert _rel(xk, xp) <= 1e-5
    x_ref = lower_solve_reference(sys_, b)
    assert _rel(xk[pad], x_ref) <= 1e-5
    padding = np.ones(lay.padded_m, bool)
    padding[pad] = False
    assert not xk[padding].any()
    bp = np.zeros(lay.padded_m, np.float32)
    bp[pad] = b
    xf = dsh.gather_vector(sts_solve_sharded(lay, mesh,
                                             b=dsh.shard_vector(bp, mesh)))
    assert _rel(xf[pad], x_ref) <= 1e-5


def test_sharded_solve_replays_from_a_graph(cuda):
    """One solve over 4 shards captured (the shard streams forked from
    the capture, the flags' memsets inside it) replays the eager bits."""
    from tpu_spmv_torch.dist.sts import sts_solve_sharded

    mat = _rcm(laplacian_2d(100))
    dsh, sys_, b, lay, pad, mesh = _sts_case(cuda, mat, "LS", 4)
    eager = torch.cat(sts_solve_sharded(lay, mesh)).clone()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = torch.cat(sts_solve_sharded(lay, mesh))
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


def test_sharded_solve_mostly_padding_on_one_card(cuda):
    """LS on a banded system: every shard mostly padding, shard 0's
    off-diagonal block empty; padding rows solve to 0 on the card."""
    from tpu_spmv_torch.dist.sts import sts_solve_sharded

    mat = random_banded(900, 25, 5, seed=7)
    dsh, sys_, b, lay, pad, mesh = _sts_case(cuda, mat, "LS", 4)
    assert not lay.ovals[0].any()
    xk = dsh.gather_vector(sts_solve_sharded(lay, mesh))
    assert _rel(xk[pad], lower_solve_reference(sys_, b)) <= 1e-5
    padding = np.ones(lay.padded_m, bool)
    padding[pad] = False
    assert not xk[padding].any()


@pytest.mark.parametrize("kind", ["ShardedIC0Preconditioner",
                                  "BlockJacobiIC0Preconditioner"])
def test_sharded_preconditioners_on_one_card(cuda, kind):
    """apply with the kernels against apply with the plain versions, and
    PCG from a captured iteration against the eager loop, 4 shards."""
    from tpu_spmv_torch.dist import sharding as dsh
    from tpu_spmv_torch.sts import ic0

    mat = _rcm(laplacian_2d(64))
    mesh = dsh.make_row_mesh([cuda] * 4)
    lay = dsh.ShardedRanked.build(mat, 4).device_put(mesh)
    pre = getattr(ic0, kind).build(mat, 4, lay.padded_m).device_put(mesh)
    r = dsh.shard_vector(np.random.default_rng(0).standard_normal(
        mat.m).astype(np.float32), mesh, lay.padded_m)
    zk = dsh.gather_vector(pre.apply(r, mesh))
    zp = dsh.gather_vector(pre.apply(r, mesh, plain=True))
    assert _rel(zk, zp) <= 1e-5 and not zk[mat.m:].any()
    b = dsh.shard_vector(np.ones(mat.m, np.float32), mesh, lay.padded_m)
    # Block-Jacobi needs more iterations than exact IC(0) here: RMS
    # 1.2e-2 after 30, 1.4e-4 after 50 (1.5e-4 for exact IC(0) after 30;
    # plain versions, CPU).
    xg, _ = ic0.pcg_ic0_sharded(lay, b, pre, mesh, iters=50, graph=True)
    xe, _ = ic0.pcg_ic0_sharded(lay, b, pre, mesh, iters=50, graph=False)
    xg = dsh.gather_vector(xg)[: mat.m]
    xe = dsh.gather_vector(xe)[: mat.m]
    assert _rel(xg, xe) <= 1e-5
    assert np.linalg.norm(mat.matvec(xg) - 1.0) / np.sqrt(mat.m) < 1e-3


def test_two_processes_share_the_card(cuda, tmp_path):
    """Two processes of a group on the one card (gloo, host-staged), two
    shards each on the (hosts=2, rows=2) mesh: every path of the suite
    "small" (SpMV with the halo and gathered, SpMM, the overlap, CG, the
    sharded solve, both IC(0)-PCGs) gives the one-process D = 4 call's
    bits, the kernels ran in both processes and found the library built
    here, and each path matches its plain version."""
    from tpu_spmv_torch.bench import multiproc
    from tpu_spmv_torch.dist import sharding as dsh

    res = multiproc.spawn(2, ["--suite", "small", "--device", "cuda",
                              "--check"], str(tmp_path), 300)
    for r, (code, log) in enumerate(res):
        assert code == 0 and f"OK process {r}" in log, (r, code, log)
    one, _ = multiproc.run_paths(multiproc.build("small"),
                                 dsh.make_row_mesh([cuda] * 4))
    for facts, rows in multiproc.load(str(tmp_path), 2):
        assert facts["backend"] == "gloo" and not facts["library_stale"]
        assert facts["launches"]["spmv_ranked"] > 0
        assert facts["launches"]["lower_solve_blocks"] > 0
        for name, (err, scale) in ((k, v["plain"]) for k, v in
                                   facts["paths"].items() if "plain" in v):
            assert err <= 1e-5 * max(1.0, scale), name
        for name, got in rows.items():
            for d, y in got.items():
                assert np.array_equal(y, one[name][d].cpu().numpy()), (
                    name, d)
