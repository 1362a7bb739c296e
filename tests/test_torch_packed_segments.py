"""The segment and run tables of the packed layout (formats/packed:
walk_fields, i.e. formats/sell.segment_fields over chunk_koff in slots,
then run_fields), which spmv_packed and spmm_packed walk on the card.

On the CPU the tables are held to a brute-force cut of chunk_koff, slot
by slot: every slot of [0, chunk_koff[-1]) lies in exactly one segment,
of its own chunk; a segment starts at its chunk's first slot or at a
sub-tile boundary inside it and touches at most SEGMENT_SUBTILES
sub-tiles; the split flag marks exactly the segments of chunks of more
than one segment, whose partial rows are numbered in order; the runs
group consecutive segments, greedily, within RUN_SUBTILES sub-tiles and
RUN_SEGMENTS segments. The container's host check refuses a segment
longer than the walk stages, a table that leaves a slot unwalked and a
run the walk cannot stage. from_csr and formats.convert.from_reference
(from the JAX package's PackedRanked) give equal tables. A plain torch
walk of the table (each segment's slots into one row, whole chunks'
rows into y, then the split chunks' partial rows added in segment order,
as the fix-up launch does) agrees with spmv_packed_reference and
spmm_packed_reference at B = 1, 5, 8 and 13, and with the Pallas kernel
in interpret mode: RelL2 <= 1e-6 and Number Wrong 0 (magnitude-aware
0.01), as in tests/test_torch_kernels.py. Matrices (the port's
bench/matrices): random_banded(3000, 90, 11) after RCM, whose clamped
last row of 90 nonzeros splits its chunk, the same with one row of 400
nonzeros, and laplacian_2d(40) after RCM, grouped and not.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_spmv.formats import packed as jpacked
from tpu_spmv.kernels.packed import spmv_packed as jax_spmv_packed

from tpu_spmv_torch.bench.harness import validate
from tpu_spmv_torch.bench.matrices import laplacian_2d, random_banded
from tpu_spmv_torch.formats import packed as tpacked
from tpu_spmv_torch.formats.convert import from_reference
from tpu_spmv_torch.formats.csr import CSRMatrix
from tpu_spmv_torch.formats.packed import PackedRanked
from tpu_spmv_torch.formats.sell import (
    LANES, MAX_SEGMENT_SUBTILES, SEGMENT_SUBTILES, SPLIT_BIT, SUBLANES,
)
from tpu_spmv_torch.kernels.packed import spmv_packed_reference
from tpu_spmv_torch.kernels.sell import ranked_bases
from tpu_spmv_torch.kernels.spmm import spmm_packed_reference
from tpu_spmv_torch.reorder import rcm


def _rcm(mat):
    return mat.permuted(rcm(mat.indptr, mat.indices))


def _long_row(mat, row=1500, length=400, seed=0):
    """mat with row `row` replaced by `length` nonzeros spread evenly over
    all columns."""
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


MATRICES = {
    "banded_clamped": lambda: _rcm(random_banded(3000, 90, 11, seed=1)),
    "long_row": lambda: _long_row(random_banded(3000, 90, 11, seed=1)),
    "lap2d_40": lambda: _rcm(laplacian_2d(40)),
}
LAYOUTS = {"grouped": dict(), "delta": dict(allow_groups=False)}


def _layout(name, kind):
    return PackedRanked.from_csr(MATRICES[name](), **LAYOUTS[kind])


def brute_segments(koff, q=SEGMENT_SUBTILES):
    """[(first slot, end slot, chunk)] by walking each chunk slot by slot
    and starting a new segment where a slot would make it touch q + 1
    sub-tiles."""
    segs = []
    for c in range(len(koff) - 1):
        start, subs = int(koff[c]), set()
        for k in range(int(koff[c]), int(koff[c + 1])):
            if k // SUBLANES not in subs and len(subs) == q:
                segs.append((start, k, c))
                start, subs = k, set()
            subs.add(k // SUBLANES)
        segs.append((start, int(koff[c + 1]), c))
    return segs


def brute_runs(segs):
    """First segment of each run, greedily: the next segment joins while
    the run touches at most RUN_SUBTILES sub-tiles and holds at most
    RUN_SEGMENTS segments."""
    runs, first = [0], segs[0][0] // SUBLANES
    for g in range(1, len(segs)):
        end = -(-segs[g][1] // SUBLANES)
        if (end - first > tpacked.RUN_SUBTILES
                or g - runs[-1] >= tpacked.RUN_SEGMENTS):
            runs.append(g)
            first = segs[g][0] // SUBLANES
    return runs + [len(segs)]


def segment_chunks(lay) -> np.ndarray:
    """Each segment's chunk: seg_chunk, or the chunk of a split
    segment's partial row (from split_seg)."""
    tag = lay.seg_chunk.numpy().astype(np.int64)
    chunk, first, end = lay.split_seg.numpy().astype(np.int64)
    split = (tag & SPLIT_BIT) != 0
    out = tag.copy()
    out[split] = np.repeat(chunk, end - first)[tag[split] & ~SPLIT_BIT]
    return out


@pytest.mark.parametrize("kind", sorted(LAYOUTS))
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_tables_match_a_brute_force_cut(name, kind):
    lay = _layout(name, kind)
    koff = lay.chunk_koff.numpy()
    segs = brute_segments(koff)
    ptr = lay.seg_ptr.numpy()
    assert lay.seg_ptr.dtype == lay.seg_chunk.dtype == torch.int32
    assert ptr.tolist() == [s for s, _, _ in segs] + [int(koff[-1])]
    assert segment_chunks(lay).tolist() == [c for _, _, c in segs]
    # Cuts inside a chunk fall on sub-tile boundaries.
    inside = ~np.isin(ptr[:-1], koff)
    assert (ptr[:-1][inside] % SUBLANES == 0).all()
    # Split segments: exactly those of chunks of several segments, with
    # partial rows 0, 1, ... in segment order, and split_seg their rows.
    per_chunk = np.bincount([c for _, _, c in segs], minlength=lay.num_chunks)
    tag = lay.seg_chunk.numpy()
    split = (tag & SPLIT_BIT) != 0
    assert np.array_equal(split, per_chunk[segment_chunks(lay)] > 1)
    assert (tag[split] & ~SPLIT_BIT).tolist() == list(range(split.sum()))
    ss = lay.split_seg.numpy()
    assert ss[0].tolist() == np.flatnonzero(per_chunk > 1).tolist()
    assert (ss[2] - ss[1]).tolist() == per_chunk[ss[0]].tolist()
    runs = brute_runs(segs)
    assert lay.run_ptr.numpy().tolist() == [runs, ptr[runs].tolist()]
    if name != "lap2d_40":  # a row of 90 or 400 nonzeros splits its chunk
        assert ss.shape[1] >= 1


def test_segments_cut_at_subtile_boundaries_inside_a_chunk():
    """Chunks of 5, 5, 5, 5 and 180 slots: the fifth chunk (slots
    20-199, sub-tiles 2-24) is cut at slots 80 and 144, so its first
    segment shares sub-tile 2 with the fourth chunk and touches 8."""
    from tpu_spmv_torch.formats.packed import walk_fields

    t = walk_fields(np.array([0, 5, 10, 15, 20, 200], np.int32))
    assert t["seg_ptr"].tolist() == [0, 5, 10, 15, 20, 80, 144, 200]
    S = SPLIT_BIT
    assert t["seg_chunk"].tolist() == [0, 1, 2, 3, 0 | S, 1 | S, 2 | S]
    assert t["split_seg"].tolist() == [[4], [0], [3]]
    # Chunks 0-3 touch sub-tiles 0-2; the long chunk's segments 8 each.
    assert t["run_ptr"].tolist() == [[0, 4, 5, 6, 7], [0, 20, 80, 144, 200]]


@pytest.mark.parametrize("kind", sorted(LAYOUTS))
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_from_reference_rebuilds_the_tables(name, kind):
    mat = MATRICES[name]()
    port = PackedRanked.from_csr(mat, **LAYOUTS[kind])
    carried = from_reference(
        jpacked.PackedRanked.from_csr(mat, **LAYOUTS[kind]))
    for f in ("chunk_koff", "seg_ptr", "seg_chunk", "split_seg", "run_ptr"):
        assert torch.equal(getattr(carried, f), getattr(port, f)), f


def _one_segment_a_chunk(lay):
    """The table of a walk that gives each chunk one segment, however
    long: what the first port's thread-a-row walk did."""
    koff = lay.chunk_koff
    C = lay.num_chunks
    return dict(seg_ptr=koff.clone(), seg_chunk=torch.arange(
        C, dtype=torch.int32), split_seg=torch.zeros(3, 0, dtype=torch.int32),
        run_ptr=torch.stack([torch.arange(C + 1, dtype=torch.int32), koff]))


def test_host_check_refuses_a_segment_longer_than_the_walk_stages():
    lay = _layout("long_row", "grouped")
    with pytest.raises(ValueError, match="a segment of .* sub-tiles"):
        dataclasses.replace(lay, **_one_segment_a_chunk(lay))


@pytest.mark.parametrize("where", ["first", "last"])
def test_host_check_refuses_a_table_that_leaves_a_slot_unwalked(where):
    lay = _layout("banded_clamped", "delta")
    seg_ptr = lay.seg_ptr.clone()
    seg_ptr[0 if where == "first" else -1] += 1 if where == "first" else -1
    with pytest.raises(ValueError, match="unwalked"):
        dataclasses.replace(lay, seg_ptr=seg_ptr)


def test_host_check_refuses_segments_outside_their_chunk():
    """Every chunk's one segment moved a slot later: each still walks
    slots in order, but the first slot of every chunk after the first
    lands in its predecessor's segment."""
    lay = _layout("lap2d_40", "delta")
    table = _one_segment_a_chunk(lay)
    table["seg_ptr"][1:-1] += 1
    table["run_ptr"][1] = table["seg_ptr"]
    with pytest.raises(ValueError, match="outside its chunk"):
        dataclasses.replace(lay, **table)


def test_host_check_refuses_a_run_the_walk_cannot_stage():
    lay = _layout("banded_clamped", "grouped")
    G = lay.seg_chunk.numel()
    one_run = torch.tensor([[0, G], [0, int(lay.seg_ptr[-1])]],
                           dtype=torch.int32)
    with pytest.raises(ValueError, match="a run touches"):
        dataclasses.replace(lay, run_ptr=one_run)
    with pytest.raises(ValueError, match="run_ptr must be"):
        dataclasses.replace(lay, run_ptr=lay.run_ptr[:, :-1])


def test_run_table_refuses_runs_the_walk_cannot_stage(monkeypatch):
    monkeypatch.setattr(tpacked, "RUN_SEGMENTS", LANES)
    with pytest.raises(ValueError, match="stages 1 to 127"):
        tpacked.run_fields(np.arange(0, 80, 5))


def segment_walk(lay, x: torch.Tensor) -> torch.Tensor:
    """y (x (n,)) or Y (X (n, B)) by the kernels' walk of the tables, in
    plain torch: each segment's slots summed into one row of 128; a
    whole chunk's segment is its rows of y; a split chunk's segments are
    partial rows that the fix-up adds into y in segment order."""
    n = lay.n
    cols = ranked_bases(lay).reshape(-1, 1) * LANES + lay.lcols.long()
    ok = (cols >= 0) & (cols < n)
    vals = lay.vals.float()
    if x.dim() == 2:
        ok, vals = ok[..., None], vals[..., None]
    prod = vals * torch.where(ok, x[cols.clamp(0, n - 1)], 0.0)
    batch = tuple(x.shape[1:])
    G = lay.seg_chunk.numel()
    owner = torch.repeat_interleave(torch.arange(G), lay.seg_ptr.diff())
    seg = torch.zeros(G, LANES, *batch).index_add_(
        0, owner, prod[: owner.numel()])
    split = (lay.seg_chunk & SPLIT_BIT) != 0
    y = torch.zeros(lay.num_chunks, LANES, *batch)
    y[lay.seg_chunk[~split].long()] = seg[~split]
    rows = torch.zeros(int(split.sum()), LANES, *batch)
    rows[(lay.seg_chunk[split] & ~SPLIT_BIT).long()] = seg[split]
    for chunk, first, end in lay.split_seg.t().tolist():
        acc = torch.zeros(LANES, *batch)
        for p in range(first, end):
            acc = acc + rows[p]
        y[chunk] = acc
    return y.reshape(-1, *batch)[: lay.m]


def _assert_close(y, other):
    y, other = y.reshape(y.shape[0], -1), other.reshape(y.shape[0], -1)
    for b in range(y.shape[1]):
        wrong, rel = validate(y[:, b], other[:, b])
        assert wrong == 0 and rel <= 1e-6, (b, wrong, rel)


@pytest.mark.parametrize("batch", [None, 1, 5, 8, 13])
@pytest.mark.parametrize("kind", sorted(LAYOUTS))
@pytest.mark.parametrize("name", ["banded_clamped", "long_row"])
def test_segment_walk_matches_the_plain_versions(name, kind, batch):
    mat = MATRICES[name]()
    lay = PackedRanked.from_csr(mat, **LAYOUTS[kind])
    assert lay.split_seg.shape[1] >= 1
    shape = (mat.n,) if batch is None else (mat.n, batch)
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    xt = torch.from_numpy(x)
    plain = spmv_packed_reference if batch is None else spmm_packed_reference
    y = segment_walk(lay, xt).numpy()
    _assert_close(y, plain(lay, xt).numpy())
    xs = x.reshape(mat.n, -1)
    _assert_close(y, np.stack([mat.matvec(xs[:, b])
                               for b in range(xs.shape[1])], 1))


@pytest.mark.parametrize("kind", sorted(LAYOUTS))
def test_segment_walk_matches_pallas(kind):
    """The plain walk of a table with a split chunk against the Pallas
    kernel on the same layout."""
    mat = MATRICES["long_row"]()
    ref = jpacked.PackedRanked.from_csr(mat, **LAYOUTS[kind])
    x = np.random.default_rng(1).standard_normal(mat.n).astype(np.float32)
    y_ref = np.asarray(jax_spmv_packed(ref, jnp.asarray(x), interpret=True))
    lay = from_reference(ref)
    assert lay.split_seg.shape[1] >= 1
    _assert_close(segment_walk(lay, torch.from_numpy(x)).numpy(), y_ref)


def test_the_walk_stages_what_the_check_allows():
    """The kernel stages the window bases of MAX_SEGMENT_SUBTILES
    sub-tiles and the ends and outputs of MAX_RUN_SEGMENTS segments, one
    per thread of its 128."""
    assert MAX_SEGMENT_SUBTILES * SUBLANES == LANES
    assert tpacked.MAX_RUN_SEGMENTS == LANES - 1
    assert 1 <= tpacked.RUN_SEGMENTS <= tpacked.MAX_RUN_SEGMENTS
    assert tpacked.RUN_SUBTILES <= MAX_SEGMENT_SUBTILES
