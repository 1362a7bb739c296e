"""The solve layouts' wait tables (formats/sell.wait_fields), the host
checks of the containers' tables, and the solve builders' device.

The solve kernels (csrc/sts.cu) wait, once each, on the chunks that the
wait table lists for their chunk, then gather. On the CPU the table is
held to what the kernels rely on: for every system of
tests/test_torch_sts.py, ranked and blocks, it is exactly the chunk
graph of the CSR (chunk c waits on b when a row of c reads a row of b,
b < c, as chip_smoke._chunk_depth computes it) plus the blocks < c that
padding slots point at, latest first; it is the same for a layout
converted from the JAX package's; and it moves and clones with its
slabs. A plain model of the kernels' order (chunks in ticket order,
each chunk's slots summed in slot order, padding gathering nothing)
reads no block outside the table and agrees with the plain version
(RelL2 <= 1e-5: both sum in f32, in different orders).

Also: a table built by hand that the kernels could not run (a segment
of more than MAX_SEGMENT_SUBTILES sub-tiles, a wait table that names a
chunk not earlier than its waiter) raises when its container is made,
and the solve builders build for the card unless asked for the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_spmv.sts import solve as jsolve

from test_torch_gpu import arrow_lower
from test_torch_segments import with_long_row
from test_torch_sts import MATS, SYSTEMS, _SOLVES, _binned, _rel
from tpu_spmv_torch.bench.matrices import random_banded
from tpu_spmv_torch.formats import sell as tsell
from tpu_spmv_torch.formats.sell import (
    LANES, MAX_SEGMENT_SUBTILES, SUBLANES, RankedSlabs, segment_fields,
    wait_fields,
)
from tpu_spmv_torch.kernels.sell import delta_bases
from tpu_spmv_torch.kernels.sts import (
    lower_solve_blocks_reference, lower_solve_ranked_reference,
)
from tpu_spmv_torch.sts import host as thost
from tpu_spmv_torch.sts import ic0 as tic0
from tpu_spmv_torch.sts import solve as tsolve


def _layout(case, ranked=True):
    name, kw = SYSTEMS[case]
    sys_ = thost.build_sts(MATS[name](), **kw)
    b = thost.compute_b(sys_.lower)
    return sys_, b, tsolve.LowerSolveLayout.build(sys_, b, ranked=ranked,
                                                  device="cpu")


def _slabs(lay, ranked):
    return lay.ranked if ranked else lay.slabs


def table(slabs) -> list:
    """The wait table as one list of chunks per chunk."""
    ptr, chunks = slabs.wait_ptr.tolist(), slabs.wait_chunk.tolist()
    return [chunks[ptr[c]:ptr[c + 1]] for c in range(slabs.num_chunks)]


def slots(slabs):
    """(owner, cols, vals) of every slot of the real sub-tiles, (S, 8,
    128) each, the columns decoded here as the plain versions do (the
    packed deltas for a ranked layout, grouped or not)."""
    S = int(slabs.chunk_ptr[-1])
    if isinstance(slabs, RankedSlabs):
        cols = (delta_bases(slabs)[:S, :, None] * LANES
                + slabs.lcols.view(-1, SUBLANES, LANES)[:S].long())
    else:
        cols = slabs.cols.view(-1, SUBLANES, LANES)[:S].long()
    owner = slabs.sub_chunk[:S].long()[:, None, None].expand_as(cols)
    vals = slabs.vals.view(-1, SUBLANES, LANES)[:S].float()
    return owner.numpy(), cols.numpy(), vals.numpy()


def chunk_graph(sys_, lay) -> set:
    """(c, b) for every chunk c and earlier chunk b whose rows c reads,
    from the CSR and the padded row positions (chip_smoke._chunk_depth)."""
    L = sys_.lower
    rows = np.repeat(np.arange(L.m, dtype=np.int64), np.diff(L.indptr))
    pad = lay.pad_index.numpy().astype(np.int64)
    c_row = pad[rows] >> 7
    c_col = pad[L.indices.astype(np.int64)] >> 7
    dep = c_col < c_row
    return set(zip(c_row[dep].tolist(), c_col[dep].tolist()))


def assert_table(sys_, lay, slabs):
    """slabs' wait table is the chunk graph plus the blocks < c that
    its padding slots point at, latest first; its real slots read
    exactly the chunk graph."""
    owner, cols, vals = slots(slabs)
    blk = cols >> 7
    real = vals != 0
    graph = chunk_graph(sys_, lay)
    assert set(zip(owner[real].tolist(), blk[real].tolist())) == graph
    pad = ~real & (cols >= 0) & (blk < owner)
    expect = graph | set(zip(owner[pad].tolist(), blk[pad].tolist()))
    got = table(slabs)
    assert sum(map(len, got)) == len(expect)
    for c, waits in enumerate(got):
        assert waits == sorted({b for (cc, b) in expect if cc == c},
                               reverse=True), c
    assert slabs.wait_ptr.dtype == slabs.wait_chunk.dtype == torch.int32


@pytest.mark.parametrize("ranked", [True, False], ids=["ranked", "blocks"])
@pytest.mark.parametrize("case", sorted(SYSTEMS))
def test_wait_table_is_the_chunk_graph(case, ranked):
    sys_, _, lay = _layout(case, ranked)
    assert_table(sys_, lay, _slabs(lay, ranked))


@pytest.mark.parametrize("ranked", [True, False], ids=["ranked", "blocks"])
@pytest.mark.parametrize("case", sorted(SYSTEMS))
def test_wait_table_same_for_a_converted_layout(case, ranked):
    sys_, b, lay = _layout(case, ranked)
    ref = jsolve.LowerSolveLayout.build(sys_, b, ranked=ranked)
    conv = tsolve.lower_solve_layout_from_jax(ref, sys_, device="cpu")
    for mine, theirs in ((lay.slabs, conv.slabs), (lay.ranked, conv.ranked)):
        assert (mine is None) == (theirs is None)
        if mine is not None:
            assert torch.equal(mine.wait_ptr, theirs.wait_ptr)
            assert torch.equal(mine.wait_chunk, theirs.wait_chunk)


@pytest.mark.parametrize("ranked", [True, False], ids=["ranked", "blocks"])
def test_wait_table_of_the_binned_layout(ranked):
    """The column-binned ranked layout, whose windows reach far blocks
    (banded_1m's route), and the blocks layout of the same system."""
    sys_ = thost.build_sts(_binned(), order_type="LS")
    lay = tsolve.LowerSolveLayout.build(sys_, thost.compute_b(sys_.lower),
                                        device="cpu")
    assert lay.ranked is not None
    assert_table(sys_, lay, _slabs(lay, ranked))


def test_wait_table_moves_and_clones_with_its_slabs():
    _, _, lay = _layout("banded_LS")
    copy = lay.clone()
    for mine, theirs in ((lay.slabs, copy.slabs), (lay.ranked, copy.ranked)):
        assert theirs.wait_chunk.data_ptr() != mine.wait_chunk.data_ptr()
        assert torch.equal(theirs.wait_ptr, mine.wait_ptr)
        assert torch.equal(theirs.wait_chunk, mine.wait_chunk)
    moved = lay.to("cpu")
    assert torch.equal(moved.ranked.wait_chunk, lay.ranked.wait_chunk)
    assert lay.ranked.nbytes == sum(
        t.numel() * t.element_size() for t in lay.ranked.tensors().values())
    assert "wait_chunk" in lay.ranked.tensors()
    # wait_fields is a function of the slabs alone.
    again = wait_fields(lay.ranked)
    assert torch.equal(again["wait_chunk"], lay.ranked.wait_chunk)


def test_moving_or_cloning_repeats_no_check(monkeypatch):
    """The tables are checked once, when the container is made: a move
    or a clone copies checked values (on the card, a check is a
    device-to-host sync)."""
    _, _, lay = _layout("banded_LS")

    def refuse(_):
        raise AssertionError("tables checked again")

    monkeypatch.setattr(tsell, "_check_tables", refuse)
    copy = lay.clone().to("cpu")
    assert torch.equal(copy.ranked.wait_chunk, lay.ranked.wait_chunk)
    assert torch.equal(copy.slabs.seg_ptr, lay.slabs.seg_ptr)
    with pytest.raises(AssertionError, match="checked again"):
        dataclasses.replace(lay.slabs, wait_ptr=None, wait_chunk=None)


def _kernel_order_solve(slabs, b_scale, x_blocks):
    """x by the kernels' order, in NumPy f32: chunks in ticket order,
    each lane summing its chunk's slots in slot order, a slot of block
    >= c (or a negative column) gathering nothing. Asserts that every
    gathered block is in the chunk's wait table."""
    owner, cols, vals = slots(slabs)
    waits = table(slabs)
    cp = slabs.chunk_ptr.numpy()
    b = b_scale.numpy().reshape(-1)
    x = np.zeros(x_blocks * LANES, np.float32)
    for c in range(slabs.num_chunks):
        acc = np.zeros(LANES, np.float32)
        for s in range(cp[c], cp[c + 1]):
            for r in range(SUBLANES):
                col = cols[s, r]
                gather = (col >= 0) & ((col >> 7) < c)
                assert set((col[gather] >> 7).tolist()) <= set(waits[c])
                xv = np.where(gather, x[np.where(gather, col, 0)], 0)
                acc += vals[s, r] * xv
        x[c * LANES:(c + 1) * LANES] = b[c * LANES:(c + 1) * LANES] - acc
    return x.reshape(x_blocks, LANES)


_ORDER_CASES = {**{k: None for k in _SOLVES}, "arrow": arrow_lower}


@pytest.mark.parametrize("ranked", [True, False], ids=["ranked", "blocks"])
@pytest.mark.parametrize("case", sorted(_ORDER_CASES))
def test_kernel_order_matches_plain(case, ranked):
    """The arrow system has chunks of up to 375 sub-tiles and a wait
    list of up to 530 chunks: past the prefetched sub-tiles and the 32
    lanes of the waiting warp."""
    if case == "arrow":
        sys_ = thost.build_sts(arrow_lower(), order_type="LS",
                               sort_packs=False)
    else:
        name, kw = _SOLVES[case]
        sys_ = thost.build_sts(MATS[name](), **kw)
    lay = tsolve.LowerSolveLayout.build(sys_, thost.compute_b(sys_.lower),
                                        ranked=ranked, device="cpu")
    slabs = _slabs(lay, ranked)
    if ranked:
        plain = lower_solve_ranked_reference(slabs, lay.b_scale)
    else:
        plain = lower_solve_blocks_reference(slabs, lay.b_scale)
    got = _kernel_order_solve(slabs, lay.b_scale, plain.shape[0])
    assert _rel(got, plain.numpy()) <= 1e-5
    if case == "arrow":
        assert int(slabs.chunk_ptr.diff().max()) > 4
        assert int(slabs.wait_ptr.diff().max()) > 32


def _long_row_layout(kind):
    mat = with_long_row(random_banded(3000, 90, 11))
    return (RankedSlabs.from_csr(mat) if kind == "ranked"
            else tsell.SellSlabs.from_csr(mat))


@pytest.mark.parametrize("length", [MAX_SEGMENT_SUBTILES,
                                    MAX_SEGMENT_SUBTILES + 1])
@pytest.mark.parametrize("kind", ["ranked", "sell"])
def test_segment_longer_than_the_walk_stages_raises(kind, length,
                                                    monkeypatch):
    """A segment table built by hand: the table at 16 sub-tiles a
    segment, with one boundary of the long row's chunk moved so its
    first segment holds `length`. 16 is accepted, 17 raises when the
    container is made, before any launch."""
    lay = _long_row_layout(kind)
    monkeypatch.setattr(tsell, "SEGMENT_SUBTILES", MAX_SEGMENT_SUBTILES)
    t = segment_fields(lay.chunk_ptr)
    sp = t["seg_ptr"].clone()
    k = int(np.flatnonzero(sp.diff().numpy() == MAX_SEGMENT_SUBTILES)[0])
    sp[k + 1] += length - MAX_SEGMENT_SUBTILES
    t["seg_ptr"] = sp
    assert int(sp.diff().max()) == length
    if length > MAX_SEGMENT_SUBTILES:
        with pytest.raises(ValueError, match=f"segment of {length} sub-tiles"):
            dataclasses.replace(lay, **t)
    else:
        dataclasses.replace(lay, **t)


def _bad_tables(slabs):
    ptr, chunks = slabs.wait_ptr, slabs.wait_chunk
    late = chunks.clone()
    late[-1] = slabs.num_chunks - 1  # the last chunk waits on itself
    short = ptr.clone()
    short[-1] -= 1
    return {
        "ptr_alone": (dict(wait_chunk=None), "together"),
        "ptr_short": (dict(wait_ptr=short), "rise from 0"),
        "names_itself": (dict(wait_chunk=late), "not earlier"),
    }


@pytest.mark.parametrize("bad", ["ptr_alone", "ptr_short", "names_itself"])
@pytest.mark.parametrize("ranked", [True, False], ids=["ranked", "blocks"])
def test_wait_table_built_by_hand_is_checked(ranked, bad):
    _, _, lay = _layout("lap2d_LS", ranked)
    slabs = _slabs(lay, ranked)
    assert int(slabs.wait_chunk[-1]) < slabs.num_chunks - 1
    fields, match = _bad_tables(slabs)[bad]
    with pytest.raises(ValueError, match=match):
        dataclasses.replace(slabs, **fields)
    # No table at all is a valid container; the kernels refuse it.
    assert dataclasses.replace(slabs, wait_ptr=None,
                               wait_chunk=None).wait_ptr is None


def _solve_layout(mat, **kw):
    sys_ = thost.build_sts(mat)
    return tsolve.LowerSolveLayout.build(sys_, thost.compute_b(sys_.lower),
                                         **kw)


_BUILDERS = {
    "lower_solve_layout": _solve_layout,
    "ic0_preconditioner": tic0.IC0Preconditioner.build,
}


@pytest.mark.parametrize("builder", sorted(_BUILDERS))
def test_solve_builders_default_to_the_card(builder, monkeypatch):
    """LowerSolveLayout.build and IC0Preconditioner.build build for the
    card unless the caller asks for the CPU, and raise, rather than
    return a CPU layout, when there is no card."""
    build = _BUILDERS[builder]
    mat = random_banded(300, 20, 6, seed=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(mat)
    lay = build(mat, device="cpu")
    assert {t.device.type for t in lay.tensors().values()} == {"cpu"}
    inner = lay if builder == "lower_solve_layout" else lay.lay_l
    assert inner.slabs.wait_ptr.device.type == "cpu"
