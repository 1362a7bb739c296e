"""The run table of the rank-windowed layout (RankedSlabs.run_ptr,
formats/packed.ranked_walk_fields), which spmm_ranked walks on the card
with the packed kernels' walk (csrc/packed.cu, seg_shift 3), on the CPU.

A ranked chunk is a whole number of sub-tiles, so the packed segment cut
of its slots (segment_fields(chunk_ptr * 8, SUBLANES)) is the ranked
table with seg_ptr times 8, and the run table is run_fields of that
seg_ptr. from_csr, formats.convert.from_reference (from the JAX
package's RankedSlabs), formats/sell.with_segments and
RankedSlabs.with_steps (which keeps the segments) give the same table;
the container's host check refuses a run table built wrong. A plain
torch walk of the runs as the kernel walks them (each run's sub-tiles in
order, a segment's row written when the walk reaches its end slot, then
the split chunks' partial rows added in segment order) matches
spmm_ranked_reference and the JAX package's spmm_ranked (Pallas,
interpret mode) at B = 1, 5, 8 and 13, on layouts with a split chunk:
RelL2 <= 1e-6 and Number Wrong 0 against each, column by column.
Matrices: random_banded(3000, 90, 11) after RCM (its clamped last row of
90 nonzeros splits its chunk), the same with a row of 400 nonzeros, and
laplacian_2d(40) after RCM, grouped and not.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_spmv.formats import csr as jcsr
from tpu_spmv.formats import sell as jsell
from tpu_spmv.kernels.spmm import spmm_ranked as jax_spmm_ranked

from tpu_spmv_torch.bench.harness import validate
from tpu_spmv_torch.formats import sell as fsell
from tpu_spmv_torch.formats.convert import from_reference
from tpu_spmv_torch.formats.packed import run_fields
from tpu_spmv_torch.formats.sell import (
    LANES, SPLIT_BIT, SUBLANES, RankedSlabs, segment_fields,
)
from tpu_spmv_torch.kernels.sell import delta_bases
from tpu_spmv_torch.kernels.spmm import spmm_ranked_reference

from test_torch_packed_segments import LAYOUTS, MATRICES


def _layout(name, kind):
    return RankedSlabs.from_csr(MATRICES[name](), **LAYOUTS[kind])


@pytest.mark.parametrize("kind", sorted(LAYOUTS))
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_run_table_is_run_fields_of_the_segments_in_slots(name, kind):
    lay = _layout(name, kind)
    assert lay.run_ptr.dtype == torch.int32
    want = run_fields(lay.seg_ptr.numpy().astype(np.int64) * SUBLANES)
    assert torch.equal(lay.run_ptr, want["run_ptr"])
    # The same cut as the packed layout's, in slots.
    slots = segment_fields(lay.chunk_ptr.numpy() * SUBLANES, SUBLANES)
    assert torch.equal(slots["seg_ptr"], lay.seg_ptr * SUBLANES)
    assert torch.equal(slots["seg_chunk"], lay.seg_chunk)
    assert torch.equal(slots["split_seg"], lay.split_seg)
    if name != "lap2d_40":
        assert lay.split_seg.shape[1] >= 1


@pytest.mark.parametrize("kind", sorted(LAYOUTS))
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_every_way_to_make_the_layout_gives_the_same_run_table(name, kind):
    mat = MATRICES[name]()
    port = RankedSlabs.from_csr(mat, **LAYOUTS[kind])
    carried = from_reference(jsell.RankedSlabs.from_csr(
        jcsr.CSRMatrix(mat.indptr, mat.indices, mat.data, mat.shape),
        **LAYOUTS[kind]))
    for other in (carried, fsell.with_segments(port), port.with_steps(2)):
        for f in ("seg_ptr", "seg_chunk", "split_seg", "run_ptr"):
            assert torch.equal(getattr(other, f), getattr(port, f)), f


def test_with_segments_recuts_the_runs(monkeypatch):
    """At 2 sub-tiles a segment the long row's chunk takes more segments,
    and the runs are cut anew over them."""
    lay = _layout("long_row", "grouped")
    monkeypatch.setattr(fsell, "SEGMENT_SUBTILES", 2)
    cut = fsell.with_segments(lay)
    assert cut.seg_chunk.numel() > lay.seg_chunk.numel()
    want = run_fields(cut.seg_ptr.numpy().astype(np.int64) * SUBLANES)
    assert torch.equal(cut.run_ptr, want["run_ptr"])


def _bad_runs(lay):
    G = lay.seg_chunk.numel()
    slots = int(lay.seg_ptr[-1]) * SUBLANES
    shifted = lay.run_ptr.clone()
    shifted[1, 1] += SUBLANES
    return {
        "one_run": (torch.tensor([[0, G], [0, slots]], dtype=torch.int32),
                    "a run touches"),
        "short": (lay.run_ptr[:, :-1], "run_ptr must be"),
        "rows_disagree": (shifted, "run_ptr must be"),
        "one_row": (lay.run_ptr[0], "run_ptr must be"),
    }


@pytest.mark.parametrize("how", ["one_run", "short", "rows_disagree",
                                 "one_row"])
def test_host_check_refuses_a_bad_run_table(how):
    lay = _layout("banded_clamped", "grouped")
    run_ptr, match = _bad_runs(lay)[how]
    with pytest.raises(ValueError, match=match):
        dataclasses.replace(lay, run_ptr=run_ptr)


def test_host_check_refuses_a_segment_without_subtiles():
    """The walk writes a segment's rows when it reaches the segment's end
    slot, so an empty segment is refused: a chunk with no sub-tiles."""
    lay = _layout("lap2d_40", "delta")
    chunk_ptr = lay.chunk_ptr.clone()
    chunk_ptr[1] = chunk_ptr[0]  # chunk 0 loses its sub-tile to chunk 1
    table = segment_fields(chunk_ptr)
    table.update(run_fields(table["seg_ptr"].numpy() * SUBLANES))
    with pytest.raises(ValueError, match="a segment without sub-tiles"):
        dataclasses.replace(lay, **table)


def run_walk(lay, X: torch.Tensor) -> torch.Tensor:
    """Y (m, B) by the kernel's walk of the run table, in plain torch: a
    run's sub-tiles in order, slot by slot, lane l adding row l's
    product; at a segment's end slot its 128 sums go to its chunk's rows
    of Y, or, for a split chunk, to its partial row, which the fix-up
    then adds into Y in segment order."""
    n, B = lay.n, X.shape[1]
    base = delta_bases(lay)  # (S, 8): the packed deltas, grouped or not
    vals = lay.vals.float()
    lcols = lay.lcols.long()
    run_ptr = lay.run_ptr.long()
    ends = (lay.seg_ptr.long() * SUBLANES).tolist()
    tags = lay.seg_chunk.tolist()
    Y = torch.zeros(lay.num_chunks * LANES, B)
    split = (lay.seg_chunk & SPLIT_BIT) != 0
    part = torch.zeros(int(split.sum()), LANES, B)
    lanes = torch.arange(LANES)
    for r in range(run_ptr.shape[1] - 1):
        e, e1 = int(run_ptr[0, r]), int(run_ptr[0, r + 1])
        k0, k1 = int(run_ptr[1, r]), int(run_ptr[1, r + 1])
        acc = torch.zeros(LANES, B)
        for k in range(k0, k1):
            if k == ends[e + 1] and e + 1 < e1:  # the segment's end
                tag = tags[e]
                if tag & SPLIT_BIT:
                    part[tag & ~SPLIT_BIT] = acc
                else:
                    Y[tag * LANES + lanes] = acc
                acc = torch.zeros(LANES, B)
                e += 1
            col = base[k // SUBLANES, k % SUBLANES] * LANES + lcols[k]
            ok = ((col >= 0) & (col < n))[:, None]
            acc = acc + vals[k][:, None] * torch.where(
                ok, X[col.clamp(0, n - 1)], 0.0)
        tag = tags[e]
        if tag & SPLIT_BIT:
            part[tag & ~SPLIT_BIT] = acc
        else:
            Y[tag * LANES + lanes] = acc
    for chunk, first, end in lay.split_seg.t().tolist():
        acc = torch.zeros(LANES, B)
        for p in range(first, end):
            acc = acc + part[p]
        Y[chunk * LANES + lanes] = acc
    return Y[: lay.m]


def _close(Y, other):
    Y, other = np.asarray(Y), np.asarray(other)
    for b in range(Y.shape[1]):
        wrong, rel = validate(Y[:, b], other[:, b])
        assert wrong == 0 and rel <= 1e-6, (b, wrong, rel)


@pytest.mark.parametrize("batch", [1, 5, 8, 13])
@pytest.mark.parametrize("kind", sorted(LAYOUTS))
@pytest.mark.parametrize("name", ["banded_clamped", "long_row", "lap2d_40"])
def test_run_walk_matches_the_plain_version_and_pallas(name, kind, batch):
    mat = MATRICES[name]()
    ref = jsell.RankedSlabs.from_csr(
        jcsr.CSRMatrix(mat.indptr, mat.indices, mat.data, mat.shape),
        **LAYOUTS[kind])
    lay = from_reference(ref)
    X = np.random.default_rng(5).standard_normal(
        (mat.n, batch)).astype(np.float32)
    Y = run_walk(lay, torch.from_numpy(X))
    _close(Y, spmm_ranked_reference(lay, torch.from_numpy(X)))
    _close(Y, jax_spmm_ranked(ref, jnp.asarray(X), interpret=True))
    _close(Y, np.stack([mat.matvec(X[:, b]) for b in range(batch)], 1))
