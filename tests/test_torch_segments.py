"""The segment table of the SELL layouts (formats/sell.segment_fields),
which spmv_ranked and spmv_sell walk on the card, one block per segment.

On the CPU the table is checked for what the kernels rely on: every
sub-tile of every real chunk lies in exactly one segment, in order; no
segment is longer than SEGMENT_SUBTILES; a chunk without sub-tiles still
has one (empty) segment; the split flag marks exactly the segments of
chunks of more than one segment, which number their partial rows in
order, and split_seg gives each split chunk and its rows; from_reference
rebuilds the table from_csr builds. A plain torch walk of the table
(per-sub-tile sums added into their segments, whole chunks' segments
into y and split chunks' partial rows by index_add_ over their chunks)
agrees with the JAX
package's Pallas kernels in interpret mode: RelL2 <= 1e-6 and Number
Wrong 0 (magnitude-aware 0.01), as in tests/test_torch_kernels.py.
Matrices: random_banded(3000, 90, 11) after RCM (its clamped last row has
90 nonzeros, so its chunk is split), the same with one row of 400
nonzeros, and with a second row of 2000 (250 sub-tiles, 32 segments).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_spmv.bench.matrices import random_banded
from tpu_spmv.formats import sell as jsell
from tpu_spmv.formats.csr import CSRMatrix
from tpu_spmv.kernels.pallas_sell import (
    spmv_ranked as jax_spmv_ranked, spmv_sell as jax_spmv_sell,
)
from tpu_spmv.reorder.rcm import rcm

from tpu_spmv_torch.bench.harness import validate
from tpu_spmv_torch.formats import sell as tsell
from tpu_spmv_torch.formats.convert import from_reference
from tpu_spmv_torch.formats.sell import (
    LANES, SEGMENT_SUBTILES, SPLIT_BIT, SUBLANES, segment_fields,
)
from tpu_spmv_torch.kernels.sell import ranked_bases
from tpu_spmv_torch.tools import spmm as spmm_cli
from tpu_spmv_torch.tools import spmv as spmv_cli

from test_torch_formats import rounded


def with_long_row(mat, row=1500, length=400, seed=0):
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


def _banded():
    mat = random_banded(3000, 90, 11)
    return mat.permuted(rcm(mat.indptr, mat.indices))


MATRICES = {
    "banded_3000": _banded,
    "long_row": lambda: with_long_row(random_banded(3000, 90, 11)),
    "two_long_rows": lambda: with_long_row(
        with_long_row(random_banded(3000, 90, 11)), row=200, length=2000,
        seed=1),
}


def _layouts(mat):
    return {
        "ranked": tsell.RankedSlabs.from_csr(mat),
        "sell": tsell.SellSlabs.from_csr(mat),
    }


def row_chunks(lay) -> torch.Tensor:
    """The chunk of each partial row, from split_seg."""
    chunk, first, end = lay.split_seg.long()
    return torch.repeat_interleave(chunk, end - first)


def segment_chunk_ids(lay) -> np.ndarray:
    """Each segment's chunk: seg_chunk, or the chunk of a split segment's
    partial row."""
    tag = lay.seg_chunk.numpy().astype(np.int64)
    split = (tag & SPLIT_BIT) != 0
    chunk = tag.copy()
    chunk[split] = row_chunks(lay).numpy()[tag[split] & ~SPLIT_BIT]
    return chunk


def assert_segments(lay):
    """The table covers every real sub-tile once, in chunk order, in
    segments of at most SEGMENT_SUBTILES sub-tiles; the split segments
    number their partial rows in order."""
    cp = lay.chunk_ptr.numpy().astype(np.int64)
    sp = lay.seg_ptr.numpy().astype(np.int64)
    tag = lay.seg_chunk.numpy().astype(np.int64)
    chunk = segment_chunk_ids(lay)
    G = tag.shape[0]
    assert sp.shape == (G + 1,) and sp[0] == 0 and sp[-1] == cp[-1]
    lens = np.diff(sp)
    assert lens.min() >= 0 and lens.max() <= SEGMENT_SUBTILES
    # In order: chunks ascend, every chunk has a segment, and each
    # segment lies inside its chunk's range.
    assert np.all(np.diff(chunk) >= 0)
    per_chunk = np.bincount(chunk, minlength=lay.num_chunks)
    assert per_chunk.shape == (lay.num_chunks,) and per_chunk.min() >= 1
    assert np.all(cp[chunk] <= sp[:-1]) and np.all(sp[1:] <= cp[chunk + 1])
    # Each real sub-tile in exactly one segment, owned by its own chunk.
    owner = np.repeat(np.arange(G), lens)
    assert owner.shape == (cp[-1],)
    assert np.array_equal(chunk[owner], lay.sub_chunk.numpy()[: cp[-1]])
    assert np.array_equal(
        per_chunk, np.maximum(-(-np.diff(cp) // SEGMENT_SUBTILES), 1))
    # The split flag marks the segments of chunks of several segments,
    # whose partial rows are 0, 1, ... in segment order.
    split = (tag & SPLIT_BIT) != 0
    assert np.array_equal(split, per_chunk[chunk] > 1)
    assert np.array_equal(tag[split] & ~SPLIT_BIT, np.arange(split.sum()))
    ss = lay.split_seg.numpy()
    assert ss.shape == (3, int((per_chunk > 1).sum()))
    assert np.array_equal(ss[0], np.flatnonzero(per_chunk > 1))
    assert np.array_equal(ss[2] - ss[1], per_chunk[ss[0]])
    assert np.array_equal(ss[1][1:], ss[2][:-1]) and ss[1][:1].sum() == 0
    assert split.sum() == G - lay.num_chunks + ss.shape[1]


@pytest.mark.parametrize("kind", ["ranked", "sell"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_segments_cover_every_subtile_in_order(name, kind):
    lay = _layouts(MATRICES[name]())[kind]
    assert_segments(lay)
    # Every matrix here has a row of more than 64 slots: a split chunk.
    assert lay.split_seg.shape[1] >= 1


def test_segment_table_cuts_at_segment_subtiles():
    """Chunks of 0, 3, 0, 17, 8, 9 and 16 sub-tiles: the empty chunks get
    one empty segment, 8 and 16 are cut at the segment length exactly,
    17 into 8, 8, 1 and 9 into 8, 1."""
    assert SEGMENT_SUBTILES == 8
    t = segment_fields(np.cumsum([0, 0, 3, 0, 17, 8, 9, 16]).astype(np.int32))
    assert t["seg_ptr"].tolist() == [
        0, 0, 3, 3, 11, 19, 20, 28, 36, 37, 45, 53]
    S = SPLIT_BIT
    assert t["seg_chunk"].tolist() == [
        0, 1, 2, 0 | S, 1 | S, 2 | S, 4, 3 | S, 4 | S, 5 | S, 6 | S]
    assert t["split_seg"].tolist() == [[3, 5, 6], [0, 3, 5], [3, 5, 7]]
    assert all(v.dtype == torch.int32 for v in t.values())


def test_segment_table_refuses_segments_the_walk_cannot_stage(monkeypatch):
    """A block stages the window bases of at most 16 sub-tiles."""
    ptr = np.array([0, 40], np.int32)
    monkeypatch.setattr(tsell, "SEGMENT_SUBTILES", 16)
    assert segment_fields(ptr)["seg_ptr"].tolist() == [0, 16, 32, 40]
    monkeypatch.setattr(tsell, "SEGMENT_SUBTILES", 17)
    with pytest.raises(ValueError, match="stages 1 to 16"):
        segment_fields(ptr)


@pytest.mark.parametrize("kind", ["ranked", "sell"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_from_reference_rebuilds_the_table(name, kind):
    mat = MATRICES[name]()
    port = _layouts(mat)[kind]
    ref = (jsell.RankedSlabs if kind == "ranked" else jsell.SellSlabs
           ).from_csr(mat)
    carried = from_reference(ref)
    for f in ("chunk_ptr", "seg_ptr", "seg_chunk", "split_seg"):
        assert torch.equal(getattr(carried, f), getattr(port, f)), f


def segment_walk(lay, x: torch.Tensor) -> torch.Tensor:
    """y by the kernels' walk of the table, in plain torch: per-sub-tile
    sums added into their segments; a whole chunk's segment is its rows,
    a split chunk's segments are partial rows added into y by index_add_
    over their chunks."""
    S = lay.num_subtiles
    if isinstance(lay, tsell.RankedSlabs):
        cols = ranked_bases(lay)[:, :, None] * LANES + lay.lcols.view(
            S, SUBLANES, LANES).long()
    else:
        cols = lay.cols.view(S, SUBLANES, LANES).long()
    ok = (cols >= 0) & (cols < lay.n)
    xg = torch.where(ok, x[cols.clamp(0, lay.n - 1)], 0.0)
    part = (lay.vals.view(S, SUBLANES, LANES).float() * xg).sum(1)
    G = lay.seg_chunk.numel()
    owner = torch.repeat_interleave(torch.arange(G), lay.seg_ptr.diff())
    seg = torch.zeros(G, LANES).index_add_(0, owner, part[: owner.numel()])
    split = (lay.seg_chunk & SPLIT_BIT) != 0
    y = torch.zeros(lay.num_chunks, LANES)
    y[lay.seg_chunk[~split].long()] = seg[~split]
    rows = torch.zeros(int(split.sum()), LANES)
    rows[(lay.seg_chunk[split] & ~SPLIT_BIT).long()] = seg[split]
    y.index_add_(0, row_chunks(lay), rows)
    return y.reshape(-1)[: lay.m]


_KINDS = {
    "ranked_grouped": dict(),
    "ranked_delta": dict(allow_groups=False),
    "ranked_bf16": dict(val_dtype=jnp.bfloat16),
    "sell": None,
}


@pytest.mark.parametrize("kind", sorted(_KINDS))
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_segment_walk_matches_pallas(name, kind):
    """The plain walk of the table (every matrix splits a chunk) against
    the Pallas kernel on the same layout, and the oracle."""
    mat = MATRICES[name]()
    kw = _KINDS[kind]
    x = np.random.default_rng(1).standard_normal(mat.n).astype(np.float32)
    if kw is None:
        ref = jsell.SellSlabs.from_csr(mat)
        y_ref = jax_spmv_sell(ref, jnp.asarray(x), interpret=True)
    else:
        ref = jsell.RankedSlabs.from_csr(mat, **kw)
        y_ref = jax_spmv_ranked(ref, jnp.asarray(x), interpret=True)
    oracle = rounded(mat) if kw and "val_dtype" in kw else mat
    lay = from_reference(ref)
    assert lay.split_seg.shape[1] >= 1
    y = segment_walk(lay, torch.from_numpy(x)).numpy()
    for other in (np.asarray(y_ref), oracle.matvec(x)):
        wrong, rel = validate(y, other)
        assert wrong == 0 and rel <= 1e-6, (wrong, rel)


def test_layout_builders_default_to_the_card(monkeypatch):
    """build_layout and build_spmm build for the card unless the caller
    asks for the CPU, and raise, rather than return a CPU layout, when
    there is no card."""
    from tpu_spmv_torch.bench.matrices import make

    mat = make("banded_1k")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spmv_cli.build_layout(mat, "ranked")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spmm_cli.build_spmm(mat, "auto", 3)
    layout, _, used = spmv_cli.build_layout(mat, "ranked", device="cpu")
    assert used == "ranked" and layout.vals.device.type == "cpu"
    layout, _, _ = spmm_cli.build_spmm(mat, "auto", 3, device="cpu")
    assert layout.vals.device.type == "cpu"
