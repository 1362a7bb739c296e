"""SELL-slab layouts as torch containers: the host builders of
`tpu_spmv.formats.sell`, ported to NumPy plus tensors.

The arrays are identical, array for array, to the JAX package's
`SellSlabs` / `RankedSlabs` on the same matrix (tests hold them equal),
so a kernel of either package can be checked against the other on one
layout. Each container adds derived fields, built from the reference's
arrays alone:

  chunk_ptr  ((num_chunks+1,) int32) the sub-tile range [chunk_ptr[c],
             chunk_ptr[c+1]) of chunk c;
  seg_ptr, seg_chunk, split_seg
             the segment table (`segment_fields`): every chunk's
             sub-tile range cut, in order, into segments of at most
             SEGMENT_SUBTILES sub-tiles. spmv_ranked and spmv_sell give
             each segment one block of 128 threads, so a chunk of a very
             long row no longer leaves one thread walking all of it while
             the card idles. A chunk of one segment writes its rows
             directly; the segments of a split chunk write partials that
             a second launch adds in segment order;
  wait_ptr, wait_chunk
             the wait table of a strict-L solve layout (`wait_fields`,
             None on other layouts): the earlier chunks whose rows each
             chunk's slots read, the chains the solve's cost walks;
  run_ptr    the run table of RankedSlabs ((2, R+1) int32,
             formats/packed.ranked_walk_fields: run_fields of seg_ptr *
             SUBLANES): consecutive segments grouped into runs that
             spmm_ranked walks with the packed kernels' walk, one block
             of 128 threads a run;
  step_seg, step_lo, step_hi, ring_blocks
             the window table of RankedSlabs (`window_fields`): the
             segments cut, in order, into steps of about STEP_SUBTILES
             sub-tiles, the x blocks [step_lo, step_hi) each step reads,
             and the ring of x blocks that spmv_ranked_windowed and
             spmm_ranked_windowed keep in shared memory.

The all-pad tail (sentinel chunk id num_chunks) lies past
chunk_ptr[num_chunks] and belongs to no segment or step. A container checks
its tables once on the host when it is made (`_check_tables`), so a
table built by hand raises before any launch; a move or a clone copies
checked tables and checks nothing.

Layout recap (see the reference module for the design): 128 rows form
a chunk (one row per lane), a chunk's nonzeros are stored slot-major as
(k, 128) slabs, and 8 slots form a sub-tile. Padding slots carry val 0
and an in-range column, so they are inert.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from tpu_spmv_torch import obs
from tpu_spmv_torch.formats.csr import CSRMatrix

LANES = 128
SUBLANES = 8
# Must equal tpu_spmv/kernels/pallas_sell.py:_UNROLL_BUDGET: pad_up_tile
# picks the ranked layout's tile (and so its tail padding) from it, and
# the layouts of the two packages must stay identical.
_UNROLL_BUDGET = 6144
# Sub-tiles per segment of the spmv_ranked/spmv_sell walk: one block
# walks at most this many in series (kernels/csrc/sell.cu). On an H100,
# 4, 8 and 16 time the same within noise on banded_1m
# (tpu_spmv_torch/bench/walk_times.py; PERF.md).
SEGMENT_SUBTILES = 8
# The most sub-tiles a segment may hold: a block of the walk stages the
# window bases of this many sub-tiles, one per thread (kMaxSegSubtiles
# in kernels/csrc/sell.cu).
MAX_SEGMENT_SUBTILES = LANES // SUBLANES
# The steps of the windowed kernels' window table: a step takes
# consecutive segments until it holds at least STEP_SUBTILES sub-tiles and
# STEP_SEGMENTS segments (one for each 128-thread group of a CTA of
# kernels/csrc/windowed.cu, which stages a step's slabs and x one step
# ahead), and never more than twice STEP_SUBTILES sub-tiles past its first
# segment (tpu_spmv_torch/bench/window_times.py times other step sizes).
STEP_SUBTILES = 8
STEP_SEGMENTS = 4
# Sub-tiles per batch of the wait-table build (8M slots).
_WAIT_BATCH = 8192
# seg_chunk flag: the segment's chunk has more than one segment, so the
# segment writes a row of partials instead of y.
SPLIT_BIT = 1 << 30


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _uniform_subtiles_per_chunk(sub_chunk, num_chunks: int) -> int:
    """q if every chunk owns exactly q sub-tiles (the all-pad tail uses
    sentinel ids and is excluded), else 0."""
    sc = np.asarray(sub_chunk)
    real = sc[sc < num_chunks]
    if real.size == 0 or real.size % max(num_chunks, 1):
        return 0
    q = real.size // num_chunks
    expect = np.repeat(np.arange(num_chunks), q)
    return q if np.array_equal(real, expect) else 0


def sigma_sort(mat: CSRMatrix, sigma: int = 32 * LANES) -> tuple:
    """SELL-C-sigma row sort (tpu_spmv.formats.sell.sigma_sort): within
    windows of `sigma` rows, rows in descending length (stable), so
    chunks get even slab heights on skewed-degree matrices. A row moves
    at most sigma - 1 places, so RCM's band survives. Returns
    (sorted_matrix, perm), perm new -> old; the columns are not
    relabelled, so callers fold perm into the rows' permutation only."""
    m = mat.m
    lens = mat.row_lengths
    perm = np.empty(m, dtype=np.int64)
    for w0 in range(0, m, sigma):
        w1 = min(w0 + sigma, m)
        order = np.argsort(-lens[w0:w1], kind="stable")
        perm[w0:w1] = w0 + order
    new_lens = lens[perm].astype(np.int64)
    indptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(new_lens, out=indptr[1:])
    starts = mat.indptr[perm].astype(np.int64)
    take = (
        np.arange(int(indptr[-1]), dtype=np.int64)
        - np.repeat(indptr[:-1], new_lens)
        + np.repeat(starts, new_lens)
    )
    out = CSRMatrix(
        indptr.astype(np.int32), mat.indices[take], mat.data[take], mat.shape
    )
    return out, perm


def matrix_key(mat: CSRMatrix, config: tuple = ()) -> np.ndarray:
    """(m, n, nnz, crc32 of indptr, indices and data, *config) as int64:
    the fingerprint a layout cache carries (tpu_spmv.formats.sell.
    matrix_key), so a cache of another matrix or configuration is refused
    at load. CSRMatrix holds the reference's dtypes (int32, int32,
    float32), so both packages compute the same key."""
    import zlib

    h = zlib.crc32(np.ascontiguousarray(mat.indptr).tobytes())
    h = zlib.crc32(np.ascontiguousarray(mat.indices).tobytes(), h)
    h = zlib.crc32(np.ascontiguousarray(mat.data).tobytes(), h)
    return np.asarray([mat.m, mat.n, mat.nnz, h, *config], dtype=np.int64)


class LayoutCacheMismatch(ValueError):
    """A layout cache does not match the matrix or the layout
    configuration asked for (a type of its own, so the CLIs' build
    fallbacks say "rebuild it" instead of switching kernels)."""


# The arrays and the static fields of a layout cache, in the order of
# the reference's tree_flatten (tpu_spmv/formats/sell.py:578-581, :814-
# 823; formats/packed.py:96-104): the .npz holds children c0, c1, ... and
# __aux__ in this order, so either package reads the other's cache.
_CACHE_FIELDS = {
    "SellSlabs": (
        ("vals", "cols", "sub_b0", "sub_nb", "sub_chunk"),
        ("m", "n", "nnz", "num_chunks", "max_nb", "chunk_q"),
    ),
    "RankedSlabs": (
        ("vals", "lcols", "sub_b0", "sub_dlo", "sub_dhi", "sub_chunk",
         "tile_b0", "grp_b0"),
        ("m", "n", "nnz", "num_chunks", "rank_nb", "chunk_q", "win_w",
         "tile_k", "group_code"),
    ),
    "PackedRanked": (
        ("vals", "lcols", "sub_b0", "sub_dlo", "sub_dhi", "bmeta", "out_row",
         "grp_b0"),
        ("m", "n", "nnz", "num_chunks", "rank_nb", "tile_k", "group_code"),
    ),
}


def save_layout(layout, path, matrix: CSRMatrix | None = None,
                config: tuple = ()) -> None:
    """Write a SellSlabs, RankedSlabs or PackedRanked to `path` in the
    reference's .npz form (tpu_spmv.formats.sell._save_layout):
    __class__, __aux__, the arrays c{i}, bf16 arrays as their uint16
    bits listed in __bf16__, and __mkey__ (matrix_key(matrix, config))
    when a matrix is given. Only the reference's arrays are written; the
    port's derived tables are rebuilt from them on load."""
    children, aux = _CACHE_FIELDS[type(layout).__name__]
    arrays, bf16 = {}, []
    for i, name in enumerate(children):
        t = getattr(layout, name).detach().cpu()
        if t.dtype == torch.bfloat16:
            bf16.append(i)
            arrays[f"c{i}"] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            arrays[f"c{i}"] = t.numpy()
    if bf16:
        arrays["__bf16__"] = np.asarray(bf16, dtype=np.int64)
    if matrix is not None:
        arrays["__mkey__"] = matrix_key(matrix, config)
    np.savez_compressed(
        path,
        __class__=type(layout).__name__,
        __aux__=np.asarray([getattr(layout, a) for a in aux], dtype=np.int64),
        **arrays,
    )


@obs.span("build.layout")
def load_layout(path, matrix: CSRMatrix | None = None, config: tuple = ()):
    """The port's container for a layout cache written by either
    package's save (tpu_spmv.formats.sell.load_layout), on the CPU, in
    the place of a build (phase build.layout).
    When `matrix` is given, the cache's fingerprint must equal
    matrix_key(matrix, config), or LayoutCacheMismatch is raised. The
    derived tables are rebuilt as formats.convert.from_reference builds
    them, and checked when the container is made."""
    import types

    from tpu_spmv_torch.formats.convert import from_reference

    with np.load(path, allow_pickle=False) as z:
        clsname = str(z["__class__"])
        aux = [int(v) for v in z["__aux__"]]
        if matrix is not None and "__mkey__" in z:
            if not np.array_equal(z["__mkey__"], matrix_key(matrix, config)):
                raise LayoutCacheMismatch(
                    f"layout cache {path} was built from a different matrix "
                    "or layout configuration (rcm/sigma/k/bin_blocks); "
                    "rebuild it"
                )
        bf16 = set(int(v) for v in z["__bf16__"]) if "__bf16__" in z else set()
        children = []
        while f"c{len(children)}" in z:
            i = len(children)
            a = z[f"c{i}"]
            children.append(
                torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                if i in bf16 else a)
    if clsname not in _CACHE_FIELDS:
        raise LayoutCacheMismatch(
            f"layout cache {path} holds a {clsname}, which this loader does "
            "not support; rebuild it"
        )
    names, aux_names = _CACHE_FIELDS[clsname]
    if len(children) != len(names) or len(aux) != len(aux_names):
        raise LayoutCacheMismatch(
            f"layout cache {path} does not hold the {clsname} fields of "
            "this version; rebuild it"
        )
    fields = dict(zip(names, children), **dict(zip(aux_names, aux)))
    return from_reference(type(clsname, (types.SimpleNamespace,), {})(
        **fields))


def _chunk_ptr(sub_chunk: np.ndarray, num_chunks: int) -> np.ndarray:
    """Sub-tile range per chunk from the sorted owner ids; the sentinel
    tail (id num_chunks) starts at chunk_ptr[num_chunks] and is left
    out."""
    return np.searchsorted(
        np.asarray(sub_chunk), np.arange(num_chunks + 1), side="left"
    ).astype(np.int32)


def segment_fields(chunk_ptr, unit: int = 1) -> dict:
    """The segment table of a chunk_ptr, as the containers' fields:

      seg_ptr      ((G+1,) int32) first sub-tile of each segment; each
                   chunk's range [chunk_ptr[c], chunk_ptr[c+1]) is cut in
                   order into segments of SEGMENT_SUBTILES sub-tiles, the
                   last one shorter; a chunk without sub-tiles gets one
                   empty segment (its rows are written as 0); seg_ptr[G]
                   = chunk_ptr[num_chunks]. With unit = SUBLANES,
                   chunk_ptr and seg_ptr count slots (PackedRanked's
                   chunk_koff, whose chunks share sub-tiles): a segment
                   starts at its chunk's first slot or at a sub-tile
                   boundary inside the chunk and touches at most
                   SEGMENT_SUBTILES sub-tiles, shared ones included;
      seg_chunk    ((G,) int32) the chunk of a segment whose chunk has no
                   other segment (it writes y), else SPLIT_BIT | p: the
                   segment writes its partial row sums into row p of a
                   (P, 128) scratch, the split chunks' segments numbered
                   in order (P = G - num_chunks + K);
      split_seg    ((3, K) int32) for each of the K split chunks, in
                   order: the chunk, its first partial row and one past
                   its last; the second launch adds those rows, in
                   order, into y.

    Raises ValueError when SEGMENT_SUBTILES exceeds the
    MAX_SEGMENT_SUBTILES whose bases a block of the kernel stages."""
    q = SEGMENT_SUBTILES
    if not 1 <= q <= MAX_SEGMENT_SUBTILES:
        raise ValueError(f"segments of {q} sub-tiles: the walk stages "
                         f"1 to {MAX_SEGMENT_SUBTILES}")
    ptr = np.asarray(chunk_ptr).astype(np.int64)
    sub0 = ptr[:-1] // unit  # each chunk's first sub-tile
    nseg = np.maximum(-(-(-(-ptr[1:] // unit) - sub0) // q), 1)
    first = np.cumsum(nseg) - nseg
    G = int(nseg.sum())
    chunk = np.repeat(np.arange(nseg.shape[0], dtype=np.int64), nseg)
    seg_ptr = np.empty(G + 1, np.int64)
    seg_ptr[:G] = np.maximum(
        ptr[chunk], (sub0[chunk] + (np.arange(G) - first[chunk]) * q) * unit)
    seg_ptr[G] = ptr[-1]
    split = nseg > 1
    end = np.cumsum(nseg[split])  # one past each split chunk's last row
    seg_chunk = chunk.copy()
    P = G - nseg.shape[0] + end.size  # every other chunk has one segment
    seg_chunk[split[chunk]] = np.arange(P) | SPLIT_BIT
    split_seg = np.stack([np.flatnonzero(split), end - nseg[split], end])
    return dict(
        seg_ptr=torch.from_numpy(seg_ptr.astype(np.int32)),
        seg_chunk=torch.from_numpy(seg_chunk.astype(np.int32)),
        split_seg=torch.from_numpy(split_seg.astype(np.int32)),
    )


def _slot_blocks(layout, s0: int, s1: int) -> np.ndarray:
    """(s1 - s0, 1024) int64 x block of every slot of sub-tiles s0..s1,
    as the solve kernels decode it: cols >> 7 for SellSlabs, base(s, r)
    from sub_b0 and the packed deltas plus lcols >> 7 for RankedSlabs
    (the deltas also hold a grouped layout's group bases)."""
    k0, k1 = s0 * SUBLANES, s1 * SUBLANES
    if isinstance(layout, RankedSlabs):
        bases = delta_bases_np(layout.sub_b0[s0:s1].cpu().numpy(),
                               layout.sub_dlo[s0:s1].cpu().numpy(),
                               layout.sub_dhi[s0:s1].cpu().numpy())
        lcols = layout.lcols[k0:k1].cpu().numpy().astype(np.int64)
        blk = bases[:, :, None] + (lcols.reshape(-1, SUBLANES, LANES) >> 7)
    else:
        blk = layout.cols[k0:k1].cpu().numpy().astype(np.int64) >> 7
    return blk.reshape(s1 - s0, SUBLANES * LANES)


def wait_fields(layout) -> dict:
    """The wait table of a strict-L solve layout (SellSlabs or
    RankedSlabs over the padded rows of sts/solve.LowerSolveLayout), as
    the containers' fields:

      wait_ptr    ((num_chunks+1,) int32) chunk c's entries are
                  wait_chunk[wait_ptr[c]:wait_ptr[c+1]];
      wait_chunk  ((W,) int32) the distinct blocks b < c that any slot
                  of chunk c reads, latest first.

    Derived from the slabs themselves, padding slots included, so it
    covers exactly what the solve kernels gather (a slot whose block is
    >= c, or whose column is negative, is padding they skip) and is the
    same for a layout built on either package. The solve's cost model
    (sts/solve.solve_cost) walks its chains; the kernels wait on the
    rows themselves."""
    C = layout.num_chunks
    cp = layout.chunk_ptr.cpu().numpy().astype(np.int64)
    owner = np.repeat(np.arange(C, dtype=np.int64), np.diff(cp))
    keys = [np.zeros(0, np.int64)]
    for s0 in range(0, owner.size, _WAIT_BATCH):
        s1 = min(s0 + _WAIT_BATCH, owner.size)
        blk = _slot_blocks(layout, s0, s1)
        c = owner[s0:s1, None]
        keys.append(np.unique((c * C + blk)[(blk >= 0) & (blk < c)]))
    key = np.unique(np.concatenate(keys))
    chunk, blk = np.divmod(key, C)
    order = np.lexsort((-blk, chunk))  # by chunk, latest block first
    ptr = np.zeros(C + 1, np.int64)
    np.cumsum(np.bincount(chunk, minlength=C), out=ptr[1:])
    return dict(
        wait_ptr=torch.from_numpy(ptr.astype(np.int32)),
        wait_chunk=torch.from_numpy(blk[order].astype(np.int32)),
    )


def with_segments(layout):
    """The layout (SellSlabs or RankedSlabs) with its segment table cut
    anew at SEGMENT_SUBTILES, and a RankedSlabs' run and window tables
    cut anew over the new segments (the run table at RUN_SUBTILES and
    RUN_SEGMENTS, the window table at its step): both name segments, so
    the three change together."""
    from tpu_spmv_torch.formats.packed import ranked_walk_fields

    ranked = isinstance(layout, RankedSlabs)
    cut = ranked_walk_fields if ranked else segment_fields
    fields = {k: v.to(layout.vals.device)
              for k, v in cut(layout.chunk_ptr.cpu()).items()}
    if ranked:
        fields.update(window_fields(
            fields["seg_ptr"], layout.sub_b0, layout.sub_dlo, layout.sub_dhi,
            layout.rank_nb, layout.step_subtiles))
        fields = {k: v.to(layout.vals.device) if isinstance(v, torch.Tensor)
                  else v for k, v in fields.items()}
    return dataclasses.replace(layout, **fields)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def window_fields(seg_ptr, sub_b0, sub_dlo, sub_dhi, rank_nb: int,
                  step_subtiles: int | None = None) -> dict:
    """The window table of a RankedSlabs, as the container's fields:

      step_seg       ((T+1,) int32) first segment of each step: from its
                     first segment on, a step takes segments until it
                     holds at least step_subtiles sub-tiles and
                     STEP_SEGMENTS segments, but stops before one that
                     would take it past 2 * step_subtiles sub-tiles (or
                     when the segments run out); step_seg[T] = G;
      step_lo, step_hi
                     ((T,) int32) the x blocks [lo, hi) the step's slots
                     read, by the rule of the reference's tile windows
                     over the walked sub-tiles only: the least and the
                     greatest window base (base(s, r), all 8 sublanes),
                     plus the paired-read blocks 2 * ceil(rank_nb / 2)
                     past the greatest; [0, 0) for a step without
                     sub-tiles. The all-pad tail lies past every segment;
      ring_blocks    the most blocks two consecutive steps read together
                     (the union of their ranges), at least 1: the ring of
                     x blocks the windowed kernels keep in shared memory.
                     Two consecutive steps whose ranges span more than the
                     ring are staged one after the other;
      step_subtiles  the step size the table was cut at (default
                     STEP_SUBTILES);
      stage_subtiles the most sub-tiles a step holds: the kernels stage
                     a step's slabs in shared memory, two steps at a time.

    seg_ptr is the segment table's (segment_fields); the other arrays
    are the layout's, as arrays or tensors."""
    q = STEP_SUBTILES if step_subtiles is None else int(step_subtiles)
    if q < 1:
        raise ValueError(f"steps of {q} sub-tiles: at least 1")
    ptr = _host(seg_ptr).astype(np.int64)
    G = ptr.size - 1
    first = [0]
    while first[-1] < G:
        j = first[-1]
        enough = int(np.searchsorted(ptr, ptr[j] + q, side="left"))
        most = int(np.searchsorted(ptr, ptr[j] + 2 * q, side="right")) - 1
        first.append(min(max(enough, j + STEP_SEGMENTS), max(most, j + 1), G))
    step_seg = np.asarray(first, np.int64)
    T = step_seg.size - 1
    walked = int(ptr[-1])
    bases = delta_bases_np(_host(sub_b0)[:walked], _host(sub_dlo)[:walked],
                           _host(sub_dhi)[:walked])
    bounds = ptr[step_seg]  # (T+1,) sub-tile range of each step
    lo = np.zeros(T, np.int64)
    hi = np.zeros(T, np.int64)
    full = bounds[1:] > bounds[:-1]
    if full.any():
        starts = bounds[:-1][full]
        lo[full] = np.minimum.reduceat(bases.min(1), starts)
        hi[full] = (np.maximum.reduceat(bases.max(1), starts)
                    + 2 * max((rank_nb + 1) // 2, 1))
    width = hi - lo
    overlap = np.maximum(
        np.minimum(hi[:-1], hi[1:]) - np.maximum(lo[:-1], lo[1:]), 0)
    union = width[:-1] + width[1:] - overlap
    ring = max(int(width.max(initial=0)), int(union.max(initial=0)), 1)
    return dict(
        step_seg=torch.from_numpy(step_seg.astype(np.int32)),
        step_lo=torch.from_numpy(lo.astype(np.int32)),
        step_hi=torch.from_numpy(hi.astype(np.int32)),
        ring_blocks=ring,
        step_subtiles=q,
        stage_subtiles=max(int(np.diff(bounds).max(initial=0)), 1),
    )


def _check_windows(layout) -> None:
    """The window table's host check (see _check_tables): steps that
    cover the segments in order, each within the ring, and every slot of
    every walked sub-tile (padding included) reading a block of its
    step's range. Raises ValueError."""
    fields = (layout.step_seg, layout.step_lo, layout.step_hi)
    if all(f is None for f in fields) or layout.seg_ptr is None:
        return  # no table, or no segments (the walks refuse the layout)
    step_seg, lo, hi = fields
    if any(f is None for f in fields) or lo.numel() != hi.numel() or (
            step_seg.numel() != lo.numel() + 1):
        raise ValueError("the window table needs step_seg (T+1,), step_lo "
                         "and step_hi (T,) together; build it with "
                         "window_fields")
    G = layout.seg_chunk.numel()
    ss, lo, hi = step_seg.long().cpu(), lo.long().cpu(), hi.long().cpu()
    if int(ss[0]) != 0 or int(ss[-1]) != G or bool((ss.diff() < 1).any()):
        raise ValueError("step_seg must rise strictly from 0 to the "
                         "segment count")
    width = hi - lo
    if bool((lo < 0).any() | (width < 0).any()) or int(
            width.max()) > layout.ring_blocks:
        raise ValueError(
            f"a step reads {int(width.max())} blocks, past the ring of "
            f"{layout.ring_blocks}, or a step range is negative")
    bounds = layout.seg_ptr.long().cpu()[ss]
    if int(bounds.diff().max()) > layout.stage_subtiles:
        raise ValueError(
            f"a step holds {int(bounds.diff().max())} sub-tiles, past the "
            f"{layout.stage_subtiles} a stage holds")
    step = torch.repeat_interleave(torch.arange(lo.numel()), bounds.diff())
    walked = int(bounds[-1])
    base = torch.from_numpy(delta_bases_np(
        _host(layout.sub_b0)[:walked], _host(layout.sub_dlo)[:walked],
        _host(layout.sub_dhi)[:walked]))
    lc = layout.lcols[: walked * SUBLANES].view(walked, SUBLANES, LANES)
    first = base + (lc.amin(-1).long().cpu() >> 7)
    last = base + (lc.amax(-1).long().cpu() >> 7)
    miss = (first < lo[step][:, None]) | (last >= hi[step][:, None])
    if bool(miss.any()):
        s = int(miss.any(1).nonzero()[0])
        raise ValueError(
            f"sub-tile {s} reads x blocks [{int(first[s].min())}, "
            f"{int(last[s].max()) + 1}) outside its step's range "
            f"[{int(lo[step[s]])}, {int(hi[step[s]])}); build the table "
            "with window_fields")


def _check_runs(layout) -> None:
    """The run table's host check (see _check_tables): segments of at
    least one sub-tile (the walk flushes a segment at its end slot) and
    runs as formats/packed.check_runs checks them, over seg_ptr in
    slots. Raises ValueError."""
    from tpu_spmv_torch.formats.packed import check_runs

    if layout.seg_ptr is None:
        return  # no segments (the walks refuse the layout)
    ptr = layout.seg_ptr.cpu().numpy().astype(np.int64) * SUBLANES
    if (np.diff(ptr) < 1).any():
        raise ValueError("a segment without sub-tiles: the run walk of "
                         "spmm_ranked needs every segment to hold one")
    check_runs(layout.run_ptr, ptr)


def _check_tables(layout) -> None:
    """Host checks of a container's derived tables, once when it is
    made (not when moved or cloned), never per call: no segment longer
    than MAX_SEGMENT_SUBTILES (a longer one would read past the bases
    the walk stages), a wait table that ends at its length and names
    only earlier chunks (a later one could deadlock the solve), and a
    RankedSlabs' run table (_check_runs) and window table, whose steps
    read only their ranges (_check_windows). Raises ValueError."""
    seg_ptr = layout.seg_ptr
    if seg_ptr is not None and seg_ptr.numel() > 1:
        longest = int(seg_ptr.diff().max())
        if longest > MAX_SEGMENT_SUBTILES:
            raise ValueError(
                f"a segment of {longest} sub-tiles: the walk stages the "
                f"bases of at most {MAX_SEGMENT_SUBTILES}; build the table "
                "with segment_fields"
            )
    if isinstance(layout, RankedSlabs):
        _check_runs(layout)
        _check_windows(layout)
    ptr, chunks = layout.wait_ptr, layout.wait_chunk
    if ptr is None and chunks is None:
        return
    if ptr is None or chunks is None or ptr.numel() != layout.num_chunks + 1:
        raise ValueError("the wait table needs wait_ptr (num_chunks+1,) and "
                         "wait_chunk together; build it with wait_fields")
    counts = ptr.long().diff()
    if int(ptr[0]) != 0 or int(ptr[-1]) != chunks.numel() or bool(
            (counts < 0).any()):
        raise ValueError("wait_ptr must rise from 0 to wait_chunk.numel()")
    owner = torch.repeat_interleave(
        torch.arange(layout.num_chunks, device=ptr.device), counts)
    if bool(((chunks < 0) | (chunks.long() >= owner)).any()):
        raise ValueError("the wait table names a chunk that is not earlier "
                         "than its waiter")


def _aligned_slots(mat: CSRMatrix, gap: int = LANES, cap_factor: float = 2.0):
    """Cluster-aligned slot assignment per 128-row chunk (see
    tpu_spmv.formats.sell._aligned_slots for the design). Returns
    (slots, kc): per-nonzero slot index and per-chunk slab height."""
    from tpu_spmv_torch.reorder import native

    if native.available():
        return native.aligned_slots(
            mat.indptr, mat.indices, gap=gap, cap_factor=cap_factor,
            lanes=LANES,
        )

    m = mat.m
    num_chunks = max(_round_up(m, LANES) // LANES, 1)
    indptr = mat.indptr.astype(np.int64)
    cols = mat.indices.astype(np.int64)
    rows = np.repeat(np.arange(m, dtype=np.int64), mat.row_lengths)
    d = cols - rows
    ordinal = np.arange(mat.nnz, dtype=np.int64) - np.repeat(
        indptr[:-1], mat.row_lengths
    )
    slots = ordinal.copy()
    kc = np.zeros(num_chunks, dtype=np.int64)

    for c in range(num_chunks):
        r0 = c * LANES
        r1 = min(r0 + LANES, m)
        e0, e1 = int(indptr[r0]), int(indptr[r1])
        if e0 == e1:
            kc[c] = 1
            continue
        dloc = d[e0:e1]
        maxlen = int((indptr[r0 + 1 : r1 + 1] - indptr[r0:r1]).max())
        order = np.argsort(dloc, kind="stable")
        ds = dloc[order]
        # Clusters split at gaps > gap, then into 64-column bins so each
        # slot's column span stays <= 64.
        newc = np.empty(ds.shape[0], dtype=bool)
        newc[0] = True
        np.greater(ds[1:] - ds[:-1], gap, out=newc[1:])
        coarse = np.cumsum(newc) - 1
        cmin = np.zeros(int(coarse[-1]) + 1, dtype=dloc.dtype)
        cmin[coarse[newc]] = ds[newc]
        bins = (ds - cmin[coarse]) >> 6
        newc |= np.concatenate(([False], bins[1:] != bins[:-1]))
        cluster_of_sorted = np.cumsum(newc) - 1
        ncl = int(cluster_of_sorted[-1]) + 1
        cluster = np.empty(ds.shape[0], dtype=np.int64)
        cluster[order] = cluster_of_sorted
        # Per-row, per-cluster ordinal (columns ascend within a row).
        rloc = rows[e0:e1] - r0
        key = rloc * ncl + cluster
        change = np.empty(key.shape[0], dtype=bool)
        change[0] = True
        np.not_equal(key[1:], key[:-1], out=change[1:])
        seg_start = np.maximum.accumulate(
            np.where(change, np.arange(key.shape[0]), 0)
        )
        within = np.arange(key.shape[0]) - seg_start
        width = np.zeros(ncl, dtype=np.int64)
        np.maximum.at(width, cluster, within)
        width += 1
        total = int(width.sum())
        if total > max(cap_factor * maxlen, maxlen + SUBLANES):
            kc[c] = maxlen  # ordinal fallback for this chunk
            continue
        base = np.zeros(ncl, dtype=np.int64)
        np.cumsum(width[:-1], out=base[1:])
        slots[e0:e1] = base[cluster] + within
        kc[c] = total
    return slots, kc


def pick_tile_k(total_k: int, cap: int = 2048) -> int:
    """Largest tile <= cap that divides total_k (a divisor scan when no
    standard tile divides)."""
    for t in (cap, 2048, 1024, 512):
        if t <= cap and total_k % t == 0:
            return t
    for t in range(min(cap, total_k), SUBLANES - 1, -SUBLANES):
        if total_k % t == 0:
            return t
    return SUBLANES


def pad_up_tile(total_k: int, cap: int, rank_nb: int, group_code: int) -> int:
    """The reference's tile choice for a rank-windowed layout, padding
    total_k up (kept so the padding, and so the arrays, match)."""
    npairs_eff = max((rank_nb + 1) // 2, 1)
    if group_code:
        G_eff = group_code >> 32
        inner = max((2 * npairs_eff * G_eff) // 8, 1)
    else:
        inner = 2 * npairs_eff
    for cand in (8192, 4096, 2048, 1024):
        if cand > cap:
            continue
        subs = cand // SUBLANES
        pad = -total_k % cand
        if subs * inner <= _UNROLL_BUDGET and pad <= 0.06 * total_k:
            return cand
    return pick_tile_k(total_k, cap)


def _binned_slots(mat: CSRMatrix, bin_blocks: int):
    """Column-binned slot assignment for scattered matrices (see
    tpu_spmv.formats.sell._binned_slots). Within every 8-slot sub-tile
    the bin spread keeps packed window deltas <= 255 blocks. Returns
    (slots, kc) like _aligned_slots."""
    if bin_blocks < 1 or (bin_blocks & (bin_blocks - 1)):
        raise ValueError("bin_blocks must be a power of two >= 1")
    m = mat.m
    nnz = mat.nnz
    num_chunks = max(_round_up(m, LANES) // LANES, 1)
    shift = 7 + int(bin_blocks).bit_length() - 1
    nbins = (max(mat.n - 1, 0) >> shift) + 1
    if nnz == 0:
        return np.zeros(0, np.int64), np.ones(num_chunks, np.int64)

    from tpu_spmv_torch.reorder import native

    if native.available():
        return native.binned_slots(mat.indptr, mat.indices, bin_blocks)

    lens = mat.row_lengths.astype(np.int64)
    rows = np.repeat(np.arange(m, dtype=np.int64), lens)
    chunks = rows >> 7
    bins = mat.indices.astype(np.int64) >> shift

    change = np.empty(nnz, dtype=bool)
    change[0] = True
    change[1:] = (rows[1:] != rows[:-1]) | (bins[1:] != bins[:-1])
    seg_start = np.maximum.accumulate(np.where(change, np.arange(nnz), 0))
    within = np.arange(nnz) - seg_start

    wkey = chunks * nbins + bins
    uk, inv = np.unique(wkey, return_inverse=True)
    width = np.zeros(uk.shape[0], dtype=np.int64)
    np.maximum.at(width, inv, within + 1)
    cums = np.cumsum(width)
    gchunk = uk // nbins
    first = np.empty(uk.shape[0], dtype=bool)
    first[0] = True
    np.not_equal(gchunk[1:], gchunk[:-1], out=first[1:])
    chunk_start = np.maximum.accumulate(
        np.where(first, cums - width, 0)
    )
    base = cums - width - chunk_start
    kc = np.zeros(num_chunks, dtype=np.int64)
    np.add.at(kc, gchunk, width)

    slots = base[inv] + within

    # Packed-delta guard: offending chunks get empty slots inserted so
    # an oversized bin jump starts a fresh sub-tile.
    gbin = uk - gchunk * nbins
    kc_off = np.zeros(num_chunks + 1, dtype=np.int64)
    np.cumsum(kc, out=kc_off[1:])
    slot_bin = np.repeat(gbin, width)
    limit_bins = max((255 - (bin_blocks - 1)) // bin_blocks, 0)

    chunk_lo = np.full(num_chunks, np.iinfo(np.int64).max)
    chunk_hi = np.full(num_chunks, -1)
    np.minimum.at(chunk_lo, gchunk, gbin)
    np.maximum.at(chunk_hi, gchunk, gbin)
    suspects = np.flatnonzero(chunk_hi - chunk_lo > limit_bins)

    bad = np.zeros(num_chunks, dtype=bool)
    for c in suspects:
        sb = slot_bin[kc_off[c] : kc_off[c + 1]]
        k8 = (sb.shape[0] // 8) * 8
        if k8:
            g = sb[:k8].reshape(-1, 8)
            if int((g[:, 7] - g[:, 0]).max()) > limit_bins:
                bad[c] = True
        tail = sb[k8:]
        if tail.size and int(tail[-1] - tail[0]) > limit_bins:
            bad[c] = True
    if bad.any():
        remap = {}
        for c in np.flatnonzero(bad):
            sb = slot_bin[kc_off[c] : kc_off[c + 1]]
            new_idx = np.empty(sb.shape[0], dtype=np.int64)
            pos = 0
            start_bin = int(sb[0])
            for i in range(sb.shape[0]):
                if pos % 8 == 0:
                    start_bin = int(sb[i])
                elif int(sb[i]) - start_bin > limit_bins:
                    pos = _round_up(pos, 8)
                    start_bin = int(sb[i])
                new_idx[i] = pos
                pos += 1
            remap[c] = new_idx
            kc[c] = pos
        for c, new_idx in remap.items():
            sel = chunks == c
            slots[sel] = new_idx[slots[sel]]

    kc = np.maximum(kc, 1)
    return slots, kc


def group_windows(sub_base, hi_units, rank_nb0: int, group_plan=None,
                  group_plan_budget=None):
    """Greedily merge sublanes whose gather windows always coincide
    (tpu_spmv.formats.sell.group_windows). With group_plan (a partition
    of the 8 sublanes as member tuples), that partition is validated
    against group_plan_budget (default: this layout's own read budget)
    instead: the shared plan of the distributed layer, where every shard
    of a stack must run the same groups. Raises ValueError when the plan
    is not a partition or a member spans the budget or more.

    Returns (sub_base_grouped, grp_b0, group_code): sub_base rewritten
    to each sublane's group minimum, grp_b0 the sub-tile-major (S*G,)
    absolute base per group, and group_code = G<<32 plus 4 bits of
    group id per sublane.
    """
    S = sub_base.shape[0]
    target = 1 if rank_nb0 == 1 else 2 * max((rank_nb0 + 1) // 2, 1)
    if group_plan is not None:
        members = [list(mem) for mem in group_plan]
        covered = sorted(r for mem in members for r in mem)
        if covered != list(range(SUBLANES)):
            raise ValueError(
                f"group_plan {group_plan} is not a partition of "
                f"the {SUBLANES} sublanes"
            )
        budget = (
            group_plan_budget if group_plan_budget is not None else target
        )
        for mem in members:
            ext = int(
                (hi_units[:, mem].max(axis=1)
                 - sub_base[:, mem].min(axis=1)).max()
            )
            if ext >= budget:
                raise ValueError(
                    f"group_plan member {tuple(mem)} spans {ext + 1} "
                    f"blocks, past the {budget}-block read budget "
                    "for this shard"
                )
    else:
        med = np.median(sub_base - sub_base.min(axis=1, keepdims=True),
                        axis=0)
        order = np.argsort(med, kind="stable")
        members = [[int(order[0])]]
        glo = sub_base[:, order[0]].copy()
        ghi = hi_units[:, order[0]].copy()
        for r in order[1:]:
            nlo = np.minimum(glo, sub_base[:, r])
            nhi = np.maximum(ghi, hi_units[:, r])
            if int((nhi - nlo).max()) < target:
                members[-1].append(int(r))
                glo, ghi = nlo, nhi
            else:
                members.append([int(r)])
                glo = sub_base[:, r].copy()
                ghi = hi_units[:, r].copy()
    G = len(members)
    gb = np.empty_like(sub_base)
    gmat = np.empty((G, S), np.int64)
    group_code = G << 32
    for gi, mem in enumerate(members):
        gmin = sub_base[:, mem].min(axis=1)
        gmat[gi] = gmin
        for r in mem:
            gb[:, r] = gmin
            group_code |= gi << (4 * r)
    return gb, gmat.T.reshape(-1).astype(np.int32), group_code


def delta_bases_np(sub_b0, sub_dlo, sub_dhi) -> np.ndarray:
    """(S, 8) int64 window base per (sub-tile, sublane) from sub_b0 and
    the packed deltas, each byte read as unsigned (the host twin of
    kernels/sell.delta_bases)."""
    shifts = np.arange(0, 32, 8, dtype=np.uint32)
    lo = (np.asarray(sub_dlo).view(np.uint32)[:, None] >> shifts) & 255
    hi = (np.asarray(sub_dhi).view(np.uint32)[:, None] >> shifts) & 255
    return (np.asarray(sub_b0).astype(np.int64)[:, None]
            + np.concatenate([lo, hi], 1).astype(np.int64))


def to_tensor(a, dtype=None) -> torch.Tensor:
    """Host array (anything np.asarray reads) -> CPU tensor. bf16, which
    torch.from_numpy rejects in its ml_dtypes form, crosses as its uint16
    bits, and uint32 as its int32 view (the kernels decode the bits). A
    tensor is taken as it is."""
    if isinstance(a, torch.Tensor):
        return a if dtype is None else a.to(dtype)
    a = np.ascontiguousarray(np.asarray(a))
    if not a.flags.writeable:  # e.g. a view of a JAX array
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)
    return t if dtype is None else t.to(dtype)


class TensorLayout:
    """Mixin for layout dataclasses: the tensor fields, and those of any
    nested layout field, move, count and clone together; every other
    field is static metadata."""

    def tensors(self) -> dict:
        """The layout's own tensor fields (nested layouts excluded)."""
        return {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }

    def _nested(self) -> dict:
        return {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), TensorLayout)
        }

    def _map(self, fn):
        # A shallow copy, not dataclasses.replace: the mapped tensors hold
        # the same values, so the copy skips __post_init__'s host checks
        # (no device-to-host sync on a move or a clone).
        out = copy.copy(self)
        for k, v in self.tensors().items():
            setattr(out, k, fn(v))
        for k, v in self._nested().items():
            setattr(out, k, v._map(fn))
        return out

    @obs.span("build.to_device")
    def to(self, device):
        return self._map(lambda t: t.to(device))

    def clone(self):
        """Copy with distinct storage (the cold-regime timing rotates
        such copies so the operator cannot stay in L2)."""
        return self._map(torch.clone)

    @property
    def nbytes(self) -> int:
        """Bytes the layout's tensors hold on their device."""
        return sum(
            t.numel() * t.element_size() for t in self.tensors().values()
        ) + sum(v.nbytes for v in self._nested().values())


@dataclasses.dataclass
class SellSlabs(TensorLayout):
    """SELL slabs with absolute int32 columns (the plain gather kernel)."""

    vals: torch.Tensor  # (total_k, 128) float32
    cols: torch.Tensor  # (total_k, 128) int32 absolute column ids
    sub_b0: torch.Tensor  # (S,) int32 first x block per sub-tile
    sub_nb: torch.Tensor  # (S,) int32 x blocks per sub-tile
    sub_chunk: torch.Tensor  # (S,) int32 owning chunk (sorted)
    chunk_ptr: torch.Tensor  # (num_chunks+1,) int32 sub-tile range per chunk
    seg_ptr: torch.Tensor  # (G+1,) int32 segment_fields: first sub-tile
    seg_chunk: torch.Tensor  # (G,) int32 chunk, or SPLIT_BIT | partial row
    split_seg: torch.Tensor  # (3, K) int32 chunk, partial rows per split chunk
    m: int
    n: int
    nnz: int
    num_chunks: int
    max_nb: int
    chunk_q: int = 0
    wait_ptr: torch.Tensor | None = None  # (num_chunks+1,) int32 wait_fields
    wait_chunk: torch.Tensor | None = None  # (W,) int32 earlier chunks read

    def __post_init__(self):
        _check_tables(self)

    @property
    def num_subtiles(self) -> int:
        return int(self.sub_b0.shape[0])

    def save(self, path, matrix: CSRMatrix | None = None,
             config: tuple = ()) -> None:
        save_layout(self, path, matrix, config)

    @property
    def padding_ratio(self) -> float:
        return int(self.vals.shape[0]) * LANES / max(self.nnz, 1)

    @property
    def hbm_bytes(self) -> int:
        """The reference's per-SpMV traffic formula (slabs, x, y and the
        partials it writes and reads), kept for like-for-like rates."""
        return (
            self.vals.numel() * 4
            + self.cols.numel() * 4
            + 4 * (self.n + self.m)
            + self.num_subtiles * LANES * 4
        )

    @classmethod
    def shape_stats(cls, mat: CSRMatrix, tile_k: int = 2048,
                    bin_blocks: int = 0, slots=None) -> tuple:
        """(num_subtiles, max_nb) of the layout from_csr would build, on
        the host alone (tpu_spmv.formats.sell.SellSlabs.shape_stats): the
        planner's cost of a stripe candidate. slots: the (ranks, kc) of
        _binned_slots(mat, bin_blocks), when the caller has them."""
        host = cls._host_build(mat, tile_k, False, bin_blocks, slabs=False,
                               slots=slots)
        sub_nb = host["sub_nb"]
        return len(sub_nb), int(sub_nb.max()) if len(sub_nb) else 1

    @classmethod
    @obs.span("build.layout")
    def from_csr(
        cls, mat: CSRMatrix, tile_k: int = 2048, align: bool = False,
        bin_blocks: int = 0,
    ) -> "SellSlabs":
        host = cls._host_build(mat, tile_k, align, bin_blocks)
        sub_nb = host["sub_nb"]
        chunk_ptr = _chunk_ptr(host["sub_chunk"], host["num_chunks"])
        return cls(
            vals=to_tensor(host["vals"]),
            cols=to_tensor(host["cols"].astype(np.int32)),
            sub_b0=to_tensor(host["sub_b0"].astype(np.int32)),
            sub_nb=to_tensor(sub_nb.astype(np.int32)),
            sub_chunk=to_tensor(host["sub_chunk"].astype(np.int32)),
            chunk_ptr=to_tensor(chunk_ptr),
            **segment_fields(chunk_ptr),
            m=host["m"],
            n=host["n"],
            nnz=mat.nnz,
            num_chunks=host["num_chunks"],
            max_nb=int(sub_nb.max()) if len(sub_nb) else 1,
            chunk_q=host["chunk_q"],
        )

    @staticmethod
    def _host_build(
        mat: CSRMatrix, tile_k: int, align: bool, bin_blocks: int,
        slabs: bool = True, slots=None,
    ) -> dict:
        """NumPy half of from_csr, shared with RankedSlabs. slabs=False
        leaves out vals and cols (the padded arrays), for shape_stats:
        the sub-tile ranges come from the entries alone. slots: the
        column-binned (ranks, kc) already computed for bin_blocks."""
        if tile_k % SUBLANES:
            raise ValueError(
                f"tile_k must be a multiple of {SUBLANES}, got {tile_k}"
            )
        m, n = mat.shape
        num_chunks = max(_round_up(m, LANES) // LANES, 1)

        rows = np.repeat(np.arange(m, dtype=np.int64), mat.row_lengths)
        if bin_blocks:
            ranks, kc_raw = (slots if slots is not None
                             else _binned_slots(mat, bin_blocks))
        elif align:
            ranks, kc_raw = _aligned_slots(mat)
        else:
            lens = np.zeros(num_chunks * LANES, dtype=np.int64)
            lens[:m] = mat.row_lengths
            kc_raw = lens.reshape(num_chunks, LANES).max(axis=1)
            ranks = np.arange(mat.nnz, dtype=np.int64) - np.repeat(
                mat.indptr[:-1].astype(np.int64), mat.row_lengths
            )

        # Slab height per chunk, quantized to 8 slots, at least one
        # sub-tile per chunk.
        kc = np.maximum(
            (kc_raw + SUBLANES - 1) // SUBLANES * SUBLANES, SUBLANES
        )
        koff = np.zeros(num_chunks + 1, dtype=np.int64)
        np.cumsum(kc, out=koff[1:])
        total_k = _round_up(int(koff[-1]), min(tile_k, 512))

        from tpu_spmv_torch.reorder import native

        if not align and not bin_blocks and native.available():
            dest_k, dest_l = native.sell_targets(mat.indptr, koff, LANES)
        else:
            dest_k = koff[rows // LANES] + ranks
            dest_l = rows % LANES
        vals = cols = None
        if slabs:
            vals = np.zeros((total_k, LANES), dtype=np.float32)
            cols = np.full((total_k, LANES), -1, dtype=np.int32)
            vals[dest_k, dest_l] = mat.data
            cols[dest_k, dest_l] = mat.indices

        # Per-sub-tile x block range [b0, b0+nb) over the real entries.
        num_subtiles = total_k // SUBLANES
        sub_of = dest_k // SUBLANES
        sub_min = np.full(num_subtiles, np.iinfo(np.int32).max, np.int64)
        np.minimum.at(sub_min, sub_of, mat.indices)
        sub_min[sub_min == np.iinfo(np.int32).max] = 0  # all-pad sub-tiles
        sub_b0 = sub_min // LANES
        sub_bmax = np.zeros(num_subtiles, np.int64)
        np.maximum.at(sub_bmax, sub_of, mat.indices)
        sub_bmax //= LANES
        sub_nb = np.maximum(sub_bmax - sub_b0 + 1, 1)

        # Padding slots point at the sub-tile's first block (in range);
        # val 0 keeps them inert.
        if slabs:
            pad_fill = np.broadcast_to(
                (sub_b0 * LANES).repeat(SUBLANES)[:, None], (total_k, LANES)
            )
            np.copyto(cols, pad_fill, where=(cols == -1))

        sub_chunk = np.full(num_subtiles, num_chunks, dtype=np.int64)
        real = int(koff[-1]) // SUBLANES
        sub_chunk[:real] = np.repeat(
            np.arange(num_chunks, dtype=np.int64), kc // SUBLANES
        )

        return dict(
            vals=vals, cols=cols, sub_b0=sub_b0, sub_nb=sub_nb,
            sub_chunk=sub_chunk, m=m, n=n, num_chunks=num_chunks,
            chunk_q=_uniform_subtiles_per_chunk(sub_chunk, num_chunks),
            dest_k=dest_k,
        )


@dataclasses.dataclass
class RankedSlabs(TensorLayout):
    """Rank-windowed SELL layout: per-sublane gather windows.

    The column of slot (sub-tile s, sublane r, lane l) is
    128 * base(s, r) + lcols[8s + r, l], where base(s, r) is
    sub_b0[s] + byte r of (sub_dlo | sub_dhi) (sublanes 0-3 in dlo, 4-7
    in dhi, read as unsigned), or grp_b0[s*G + groups[r]] when the
    layout is grouped (group_code != 0).
    """

    vals: torch.Tensor  # (total_k, 128) float32 or bfloat16
    lcols: torch.Tensor  # (total_k, 128) uint8, int16 or int32
    sub_b0: torch.Tensor  # (S,) int32
    sub_dlo: torch.Tensor  # (S,) int32 view of uint32 packed deltas
    sub_dhi: torch.Tensor  # (S,) int32 view of uint32 packed deltas
    sub_chunk: torch.Tensor  # (S,) int32
    tile_b0: torch.Tensor  # (T,) int32 (windowed variant's metadata)
    grp_b0: torch.Tensor  # (S*G,) int32, empty when ungrouped
    chunk_ptr: torch.Tensor  # (num_chunks+1,) int32
    seg_ptr: torch.Tensor  # (G+1,) int32 segment_fields (see SellSlabs)
    seg_chunk: torch.Tensor  # (G,) int32
    split_seg: torch.Tensor  # (3, K) int32
    run_ptr: torch.Tensor  # (2, R+1) int32 first segment, slot of each run
    m: int
    n: int
    nnz: int
    num_chunks: int
    rank_nb: int
    chunk_q: int = 0
    win_w: int = 0
    tile_k: int = 2048
    group_code: int = 0
    wait_ptr: torch.Tensor | None = None  # (num_chunks+1,) int32 wait_fields
    wait_chunk: torch.Tensor | None = None  # (W,) int32 earlier chunks read
    step_seg: torch.Tensor | None = None  # (T+1,) int32 window_fields
    step_lo: torch.Tensor | None = None  # (T,) int32 first x block per step
    step_hi: torch.Tensor | None = None  # (T,) int32 one past its last
    ring_blocks: int = 0  # window_fields: x blocks of the kernels' ring
    step_subtiles: int = 0  # window_fields: the step size it was cut at
    stage_subtiles: int = 0  # window_fields: the most sub-tiles a step holds

    def __post_init__(self):
        _check_tables(self)

    def with_steps(self, step_subtiles: int) -> "RankedSlabs":
        """This layout with its window table cut anew at step_subtiles
        sub-tiles a step (window_fields), on the layout's device: fewer
        sub-tiles a step, a smaller ring."""
        fields = window_fields(self.seg_ptr, self.sub_b0, self.sub_dlo,
                               self.sub_dhi, self.rank_nb, step_subtiles)
        dev = self.vals.device
        return dataclasses.replace(self, **{
            k: v.to(dev) if isinstance(v, torch.Tensor) else v
            for k, v in fields.items()})

    @property
    def groups(self) -> tuple:
        """Sublane -> group map decoded from group_code."""
        return tuple((self.group_code >> (4 * r)) & 15 for r in range(SUBLANES))

    @property
    def num_groups(self) -> int:
        return self.group_code >> 32

    @property
    def num_subtiles(self) -> int:
        return int(self.sub_b0.shape[0])

    def save(self, path, matrix: CSRMatrix | None = None,
             config: tuple = ()) -> None:
        save_layout(self, path, matrix, config)

    @property
    def padding_ratio(self) -> float:
        return int(self.vals.shape[0]) * LANES / max(self.nnz, 1)

    @property
    def hbm_bytes(self) -> int:
        """The reference's per-SpMV traffic formula (see SellSlabs)."""
        return (
            self.vals.numel() * self.vals.element_size()
            + self.lcols.numel() * self.lcols.element_size()
            + 4 * (self.n + self.m)
            + self.num_subtiles * LANES * 4
        )

    @property
    def group_members(self) -> tuple:
        """The group partition as member tuples ((sublanes of group 0),
        ...): the group_plan that from_csr takes, so one layout's groups
        can be applied to its sibling shards."""
        g = self.groups
        return tuple(tuple(r for r in range(SUBLANES) if g[r] == gi)
                     for gi in range(max(g) + 1))

    @classmethod
    @obs.span("build.layout")
    def from_csr(
        cls, mat: CSRMatrix, tile_k: int = 2048, align: bool = True,
        bin_blocks: int = 0, allow_groups: bool = True,
        group_plan: tuple | None = None,
        group_plan_budget: int | None = None, val_dtype=None,
    ) -> "RankedSlabs":
        """val_dtype: value storage, torch.float32 (default) or
        torch.bfloat16 (the kernels widen to f32 on load, so only the
        storage is rounded). Raises ValueError when a sub-tile's window
        bases span more than the 256-block packed-delta range.

        group_plan: a group partition fixed from outside (member tuples,
        see group_members) in place of the greedy merge, as the
        distributed layer's ShardedRanked gives every shard shard 0's
        plan; group_plan_budget: the read budget (x blocks) the plan is
        validated against, the planning shard's. Raises ValueError when
        this matrix's windows cannot keep the plan within the budget."""
        from tpu_spmv_torch.formats.packed import ranked_walk_fields

        host = SellSlabs._host_build(mat, tile_k, align, bin_blocks)
        cols = host["cols"]
        vals = host["vals"]
        dest_k = host.pop("dest_k")
        total_k = cols.shape[0]
        S = total_k // SUBLANES

        # Per-(sub-tile, sublane) window base over the real entries.
        SENT = np.iinfo(np.int32).max
        units_e = mat.indices.astype(np.int64) >> 7
        flat_lo = np.full(total_k, SENT, np.int64)
        np.minimum.at(flat_lo, dest_k, units_e)
        flat_hi = np.full(total_k, -1, np.int64)
        np.maximum.at(flat_hi, dest_k, units_e)
        sub_base = flat_lo.reshape(S, SUBLANES)
        empty = sub_base == SENT
        tile_min = sub_base.min(axis=1)
        tile_min[tile_min == SENT] = 0
        sub_base = np.where(empty, tile_min[:, None], sub_base)

        group_code = 0
        grp_b0 = np.zeros(0, np.int32)
        if (allow_groups or group_plan is not None) and S:
            hi_units = flat_hi.reshape(S, SUBLANES)
            hi_units = np.where(hi_units < 0, sub_base, hi_units)
            rank_nb0 = int((hi_units - sub_base).max()) + 1
            sub_base, grp_b0, group_code = group_windows(
                sub_base, hi_units, rank_nb0, group_plan=group_plan,
                group_plan_budget=group_plan_budget,
            )

        # Local columns; padding slots point at the window's first entry.
        real3 = (vals != 0.0).reshape(S, SUBLANES, LANES)
        c3 = cols.reshape(S, SUBLANES, LANES)
        c3 -= (sub_base[:, :, None] << 7).astype(cols.dtype)
        np.copyto(c3, 0, where=~real3)
        lcols = cols
        rank_nb = (int(lcols.max()) >> 7) + 1 if S else 1
        if S and int(lcols.min()) < 0:
            raise ValueError("window base exceeds its own entries")
        lmax = int(lcols.max()) if lcols.size else 0
        lcols = lcols.astype(
            np.uint8 if lmax < 2**8
            else np.int16 if lmax < 2**15
            else np.int32
        )

        sub_b0 = sub_base.min(axis=1)
        deltas = sub_base - sub_b0[:, None]
        if deltas.size and deltas.max() > 255:
            raise ValueError(
                "sub-tile block span exceeds the packed-delta range (256 "
                "blocks); use the plain SellSlabs kernel for this matrix"
            )
        deltas = deltas.astype(np.uint32)
        sub_dlo = np.zeros(S, dtype=np.uint32)
        sub_dhi = np.zeros(S, dtype=np.uint32)
        for r in range(4):
            sub_dlo |= deltas[:, r] << (8 * r)
            sub_dhi |= deltas[:, r + 4] << (8 * r)

        tile_eff = pad_up_tile(total_k, tile_k, rank_nb, group_code)
        pad_k = -total_k % tile_eff
        if pad_k:
            pad_s = pad_k // SUBLANES
            vals = np.concatenate([vals, np.zeros((pad_k, LANES), vals.dtype)])
            lcols = np.concatenate(
                [lcols, np.zeros((pad_k, LANES), lcols.dtype)]
            )
            sub_base = np.concatenate([
                sub_base,
                np.broadcast_to(sub_base[-1], (pad_s, SUBLANES)).copy(),
            ])
            sub_b0 = np.concatenate(
                [sub_b0, np.full(pad_s, sub_b0[-1], sub_b0.dtype)]
            )
            sub_dlo = np.concatenate([sub_dlo, np.zeros(pad_s, sub_dlo.dtype)])
            sub_dhi = np.concatenate([sub_dhi, np.zeros(pad_s, sub_dhi.dtype)])
            host["sub_chunk"] = np.concatenate([
                host["sub_chunk"],
                np.full(pad_s, host["num_chunks"], host["sub_chunk"].dtype),
            ])
            if group_code:
                grp_b0 = np.concatenate(
                    [grp_b0, np.zeros(pad_s * (group_code >> 32), grp_b0.dtype)]
                )
            S += pad_s
            total_k += pad_k

        subs_per_tile = tile_eff // SUBLANES
        T = S // subs_per_tile
        base_t = sub_base.reshape(T, subs_per_tile * SUBLANES)
        tile_b0 = base_t.min(axis=1)
        reads_nb = 2 * max((rank_nb + 1) // 2, 1)
        win_w = (
            int((base_t.max(axis=1) - tile_b0).max()) + reads_nb if T else 2
        )
        win_w = _round_up(max(win_w, SUBLANES), SUBLANES)
        chunk_ptr = _chunk_ptr(host["sub_chunk"], host["num_chunks"])
        segments = ranked_walk_fields(chunk_ptr)

        return cls(
            vals=to_tensor(vals, val_dtype or torch.float32),
            lcols=to_tensor(lcols),
            sub_b0=to_tensor(sub_b0.astype(np.int32)),
            sub_dlo=to_tensor(sub_dlo),
            sub_dhi=to_tensor(sub_dhi),
            sub_chunk=to_tensor(host["sub_chunk"].astype(np.int32)),
            tile_b0=to_tensor(tile_b0.astype(np.int32)),
            grp_b0=to_tensor(grp_b0.astype(np.int32)),
            chunk_ptr=to_tensor(chunk_ptr),
            **segments,
            m=host["m"],
            n=host["n"],
            nnz=mat.nnz,
            num_chunks=host["num_chunks"],
            rank_nb=rank_nb,
            chunk_q=host["chunk_q"],
            win_w=win_w,
            tile_k=tile_eff,
            group_code=group_code,
            **window_fields(segments["seg_ptr"], sub_b0, sub_dlo, sub_dhi,
                            rank_nb),
        )
