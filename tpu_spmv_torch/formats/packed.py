"""Packed mixed-height rank-windowed slabs as a torch container: the
host-side `from_csr` of `tpu_spmv.formats.packed`, ported to NumPy plus
tensors.

Chunk slabs stack back to back at slot granularity (kc = max(true slot
count, MIN_KC)) instead of being rounded up to the 8-slot sub-tile, so a
sub-tile may hold the tail of one chunk, whole chunks and the head of
the next. The arrays are identical, array for array, to the JAX
package's `PackedRanked` on the same matrix (tests hold them equal),
including the TPU kernel's segment metadata (`bmeta`, `out_row`), which
the port carries but does not read.

The port adds derived fields, built from the reference's arrays alone:

  chunk_koff ((num_chunks+1,) int32) chunk c's slots are
             [chunk_koff[c], chunk_koff[c+1]);
  seg_ptr, seg_chunk, split_seg
             the segment table (formats/sell.segment_fields over
             chunk_koff, in slots): each chunk's slots cut, in order, at
             sub-tile boundaries inside the chunk into segments that
             touch at most SEGMENT_SUBTILES sub-tiles, so only a
             segment's first and last sub-tile can be shared with another
             chunk. A chunk of one segment writes y directly, the
             segments of a split chunk write partial rows that a second
             launch adds in segment order;
  run_ptr    the run table (`run_fields`): consecutive segments grouped
             into runs of at most RUN_SUBTILES sub-tiles and RUN_SEGMENTS
             segments. spmv_packed and spmm_packed give each run one block
             of 128 threads, thread l row l of each of its segments'
             chunks. RankedSlabs carries the same table over its segments
             of whole sub-tiles (`ranked_walk_fields`), which spmm_ranked
             walks with the same kernel.

The TPU kernel's cross-sub-tile carry, its two partial rows per sub-tile
and the `out_row` gather do not exist in the port.

Slots past chunk_koff[num_chunks] are padding and are never read. The
container checks the tables once on the host when it is made
(`_check_segments`, with `check_runs`), so a table built by hand raises
before any launch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_spmv_torch import obs
from tpu_spmv_torch.formats.csr import CSRMatrix
from tpu_spmv_torch.formats.sell import (
    LANES,
    MAX_SEGMENT_SUBTILES,
    SPLIT_BIT,
    SUBLANES,
    TensorLayout,
    _aligned_slots,
    _binned_slots,
    _round_up,
    group_windows,
    pad_up_tile,
    segment_fields,
    to_tensor,
)

# Minimum slab height: bounds chunk ends per 8-slot sub-tile to two
# (consecutive ends are >= MIN_KC apart; a sub-tile spans 7 positions).
MIN_KC = 4
# The runs of the packed walk: a block of kernels/csrc/packed.cu walks a
# run of consecutive segments, taking the next one while the run still
# touches at most RUN_SUBTILES sub-tiles (a segment alone may touch
# SEGMENT_SUBTILES) and holds at most RUN_SEGMENTS segments; 0 sub-tiles
# gives every segment a block of its own.
RUN_SUBTILES = 8
RUN_SEGMENTS = 8
# The most segments a run may hold: a block stages each segment's end and
# output, one per thread.
MAX_RUN_SEGMENTS = LANES - 1


@dataclasses.dataclass
class PackedRanked(TensorLayout):
    """Mixed-height rank-windowed slabs (see module docstring).

    The column of slot k (sub-tile s = k // 8, sublane r = k % 8) at
    lane l is 128 * base(s, r) + lcols[k, l], with base(s, r) decoded as
    in RankedSlabs: sub_b0[s] plus byte r of sub_dlo/sub_dhi, or
    grp_b0[s*G + groups[r]] when group_code != 0.
    """

    vals: torch.Tensor  # (total_k, 128) float32 or bfloat16
    lcols: torch.Tensor  # (total_k, 128) uint8, int16 or int32
    sub_b0: torch.Tensor  # (S,) int32
    sub_dlo: torch.Tensor  # (S,) int32 view of uint32 packed deltas
    sub_dhi: torch.Tensor  # (S,) int32 view of uint32 packed deltas
    bmeta: torch.Tensor  # (S,) int32 b1 | b2 << 4 | E << 8 (TPU kernel's)
    out_row: torch.Tensor  # (num_chunks,) int32 partial row (TPU kernel's)
    grp_b0: torch.Tensor  # (S*G,) int32, empty when ungrouped
    chunk_koff: torch.Tensor  # (num_chunks+1,) int32 slot range per chunk
    seg_ptr: torch.Tensor  # (G+1,) int32 segment_fields: first slot
    seg_chunk: torch.Tensor  # (G,) int32 chunk, or SPLIT_BIT | partial row
    split_seg: torch.Tensor  # (3, K) int32 chunk, partial rows per split chunk
    run_ptr: torch.Tensor  # (2, R+1) int32 run_fields: first segment, slot
    m: int
    n: int
    nnz: int
    num_chunks: int
    rank_nb: int
    tile_k: int
    group_code: int = 0

    def __post_init__(self):
        _check_segments(self)

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

    @property
    def padding_ratio(self) -> float:
        return int(self.vals.shape[0]) * LANES / max(self.nnz, 1)

    def save(self, path, matrix: CSRMatrix | None = None,
             config: tuple = ()) -> None:
        """The reference's .npz layout cache (formats/sell.save_layout)."""
        from tpu_spmv_torch.formats.sell import save_layout

        save_layout(self, path, matrix, config)

    @property
    def hbm_bytes(self) -> int:
        """The reference's per-SpMV traffic formula (slabs, x, y and its
        two partial rows per sub-tile), kept for like-for-like rates."""
        return (
            self.vals.numel() * self.vals.element_size()
            + self.lcols.numel() * self.lcols.element_size()
            + 4 * (self.n + self.m)
            + 2 * self.num_subtiles * LANES * 4
        )

    @classmethod
    @obs.span("build.layout")
    def from_csr(
        cls, mat: CSRMatrix, tile_k: int = 2048, allow_groups: bool = True,
        val_dtype=None, bin_blocks: int = 0,
    ) -> "PackedRanked":
        """val_dtype: value storage, torch.float32 (default) or
        torch.bfloat16. bin_blocks > 0 takes column-binned slots
        instead of cluster-aligned ones. Raises ValueError when a
        sub-tile's window bases span more than the 256-block
        packed-delta range (back-to-back slabs can put distant chunks
        into one sub-tile; callers fall back to RankedSlabs)."""
        m, n = mat.shape
        num_chunks = max(_round_up(m, LANES) // LANES, 1)

        if bin_blocks:
            ranks, kc_raw = _binned_slots(mat, bin_blocks)
        else:
            ranks, kc_raw = _aligned_slots(mat)
        kc = np.maximum(kc_raw, MIN_KC)
        koff = np.zeros(num_chunks + 1, dtype=np.int64)
        np.cumsum(kc, out=koff[1:])
        total_k = _round_up(int(koff[-1]), 512)

        vals = np.zeros((total_k, LANES), dtype=np.float32)
        cols = np.full((total_k, LANES), -1, dtype=np.int32)
        rows = np.repeat(np.arange(m, dtype=np.int64), mat.row_lengths)
        dest_k = koff[rows // LANES] + ranks
        dest_l = rows % LANES
        vals[dest_k, dest_l] = mat.data
        cols[dest_k, dest_l] = mat.indices

        # Per-(sub-tile, sublane) window base over the real slots.
        S = total_k // SUBLANES
        units = np.where(cols >= 0, cols >> 7, np.iinfo(np.int32).max)
        big = units.reshape(S, SUBLANES, LANES)
        sub_base = big.min(axis=2)
        empty = sub_base == np.iinfo(np.int32).max
        tile_min = sub_base.min(axis=1)
        tile_min[tile_min == np.iinfo(np.int32).max] = 0
        sub_base = np.where(empty, tile_min[:, None], sub_base)

        real = cols >= 0
        group_code = 0
        grp_b0 = np.zeros(0, np.int32)
        if allow_groups and S:
            hi_units = np.where(real, units, -1).reshape(
                S, SUBLANES, LANES
            ).max(axis=2)
            hi_units = np.where(hi_units < 0, sub_base, hi_units)
            rank_nb0 = int((hi_units - sub_base).max()) + 1
            sub_base, grp_b0, group_code = group_windows(
                sub_base, hi_units, rank_nb0
            )

        base_cols = np.repeat(sub_base.reshape(-1), LANES).reshape(
            total_k, LANES
        )
        lcols = np.where(real, cols - (base_cols << 7), 0)
        lmax = int(lcols.max()) if S else 0
        rank_nb = (lmax >> 7) + 1 if S else 1
        if S and int(lcols.min()) < 0:
            raise ValueError("window base exceeds its own entries")
        lcols = lcols.astype(
            np.uint8 if lmax < 2**8
            else np.int16 if lmax < 2**15
            else np.int32
        )

        sub_b0 = sub_base.min(axis=1)
        deltas = sub_base - sub_b0[:, None]
        if deltas.size and deltas.max() > 255:
            raise ValueError(
                "sub-tile block span exceeds the packed-delta range "
                "(256 blocks); use SellSlabs for this matrix"
            )
        deltas = deltas.astype(np.uint32)
        sub_dlo = np.zeros(S, dtype=np.uint32)
        sub_dhi = np.zeros(S, dtype=np.uint32)
        for r in range(4):
            sub_dlo |= deltas[:, r] << (8 * r)
            sub_dhi |= deltas[:, r + 4] << (8 * r)

        # The TPU kernel's segment metadata: chunk c ends in sub-tile
        # s = (koff[c+1]-1) // 8 at boundary position koff[c+1] - 8s, in
        # (0, 8]; its total lands in partial row 2s (first end in s) or
        # 2s+1 (second).
        ends = koff[1:]
        s_of = (ends - 1) // SUBLANES
        bpos = ends - s_of * SUBLANES
        start_idx = np.searchsorted(s_of, np.arange(S), side="left")
        rank_in = np.arange(num_chunks, dtype=np.int64) - start_idx[s_of]
        out_row = 2 * s_of + rank_in

        b1 = np.zeros(S, dtype=np.int64)
        b2 = np.zeros(S, dtype=np.int64)
        E = np.zeros(S, dtype=np.int64)
        np.add.at(E, s_of, 1)
        if int(E.max(initial=0)) > 2:
            raise ValueError(
                ">2 chunk ends in one sub-tile (MIN_KC violated)"
            )
        b1[s_of[rank_in == 0]] = bpos[rank_in == 0]
        b2[:] = b1
        b2[s_of[rank_in == 1]] = bpos[rank_in == 1]
        bmeta = (b1 | (b2 << 4) | (E << 8)).astype(np.int32)

        # Pad total_k up to the reference's grid tile so the arrays
        # match. Pad sub-tiles replicate the last window base (grouped
        # bases are 0) and lie past chunk_koff[-1].
        tile_eff = pad_up_tile(total_k, tile_k, rank_nb, group_code)
        pad_k = -total_k % tile_eff
        if pad_k:
            pad_s = pad_k // SUBLANES
            vals = np.concatenate([vals, np.zeros((pad_k, LANES), vals.dtype)])
            lcols = np.concatenate(
                [lcols, np.zeros((pad_k, LANES), lcols.dtype)]
            )
            sub_b0 = np.concatenate(
                [sub_b0, np.full(pad_s, sub_b0[-1], sub_b0.dtype)]
            )
            sub_dlo = np.concatenate([sub_dlo, np.zeros(pad_s, sub_dlo.dtype)])
            sub_dhi = np.concatenate([sub_dhi, np.zeros(pad_s, sub_dhi.dtype)])
            bmeta = np.concatenate([bmeta, np.zeros(pad_s, bmeta.dtype)])
            if group_code:
                grp_b0 = np.concatenate(
                    [grp_b0, np.zeros(pad_s * (group_code >> 32), grp_b0.dtype)]
                )

        return cls(
            vals=to_tensor(vals, val_dtype or torch.float32),
            lcols=to_tensor(lcols),
            sub_b0=to_tensor(sub_b0.astype(np.int32)),
            sub_dlo=to_tensor(sub_dlo),
            sub_dhi=to_tensor(sub_dhi),
            bmeta=to_tensor(bmeta),
            out_row=to_tensor(out_row.astype(np.int32)),
            grp_b0=to_tensor(grp_b0.astype(np.int32)),
            chunk_koff=to_tensor(koff.astype(np.int32)),
            **walk_fields(koff),
            m=m,
            n=n,
            nnz=mat.nnz,
            num_chunks=num_chunks,
            rank_nb=rank_nb,
            tile_k=tile_eff,
            group_code=group_code,
        )


def chunk_koff_from_segments(out_row, bmeta) -> np.ndarray:
    """chunk_koff rebuilt from the TPU kernel's segment metadata alone:
    chunk c ends in sub-tile s = out_row[c] // 2 at position b1[s] (first
    end, even row) or b2[s] (second end, odd row), so its exclusive end
    slot is 8s + that position."""
    out_row = np.asarray(out_row).astype(np.int64)
    bmeta = np.asarray(bmeta).astype(np.int64)
    s = out_row // 2
    pos = np.where(out_row % 2 == 0, bmeta[s] & 15, (bmeta[s] >> 4) & 15)
    koff = np.zeros(out_row.shape[0] + 1, np.int64)
    koff[1:] = SUBLANES * s + pos
    return koff.astype(np.int32)


def run_fields(seg_ptr) -> dict:
    """The run table over a packed segment table's seg_ptr (in slots):

      run_ptr  ((2, R+1) int32) the first segment of each run, and its
               first slot (seg_ptr at that segment, so a block reads its
               slot range without a second round trip): from its first
               segment on, a run takes the next segment while the
               sub-tiles its segments touch together number at most
               RUN_SUBTILES and it holds at most RUN_SEGMENTS segments;
               run_ptr[:, R] = (G, seg_ptr[G]).

    A block of the packed walk walks one run. Raises ValueError when
    RUN_SEGMENTS exceeds the MAX_RUN_SEGMENTS a block stages."""
    if not 1 <= RUN_SEGMENTS <= MAX_RUN_SEGMENTS:
        raise ValueError(f"runs of {RUN_SEGMENTS} segments: the walk "
                         f"stages 1 to {MAX_RUN_SEGMENTS}")
    ptr = np.asarray(seg_ptr).astype(np.int64)
    G = ptr.size - 1
    first = ptr[:-1] // SUBLANES  # first sub-tile of each segment
    end = -(-ptr[1:] // SUBLANES)  # one past its last
    runs = [0]
    while runs[-1] < G:
        j = runs[-1]
        fits = int(np.searchsorted(end, first[j] + RUN_SUBTILES, "right"))
        runs.append(min(max(fits, j + 1), j + RUN_SEGMENTS, G))
    runs = np.asarray(runs, np.int64)
    return dict(run_ptr=torch.from_numpy(
        np.stack([runs, ptr[runs]]).astype(np.int32)))


def walk_fields(chunk_koff) -> dict:
    """The segment and run tables of a chunk_koff, as the container's
    fields (segment_fields in slots, then run_fields)."""
    segments = segment_fields(chunk_koff, SUBLANES)
    return dict(segments, **run_fields(segments["seg_ptr"]))


def ranked_walk_fields(chunk_ptr) -> dict:
    """The segment table of a RankedSlabs' chunk_ptr (segment_fields in
    sub-tiles, as spmv_ranked walks it) and the run table over the same
    cut in slots (run_fields of seg_ptr * SUBLANES), which spmm_ranked
    walks with this module's kernel: a ranked chunk is a whole number of
    sub-tiles, so segment_fields(chunk_ptr * SUBLANES, SUBLANES) is the
    same cut."""
    segments = segment_fields(chunk_ptr)
    return dict(segments, **run_fields(
        segments["seg_ptr"].numpy().astype(np.int64) * SUBLANES))


def with_segments(layout: "PackedRanked") -> "PackedRanked":
    """The layout with its segment and run tables cut anew at
    SEGMENT_SUBTILES, RUN_SUBTILES and RUN_SEGMENTS, on its device."""
    fields = walk_fields(layout.chunk_koff.cpu())
    return dataclasses.replace(layout, **{
        k: v.to(layout.vals.device) for k, v in fields.items()})


def _check_segments(layout) -> None:
    """The segment table's host check, once when the container is made
    (not when moved or cloned), never per call: segments that walk every
    slot of [0, chunk_koff[-1]) once, in order, each inside its own
    chunk's range and touching at most MAX_SEGMENT_SUBTILES sub-tiles
    (the walk stages the window bases of that many), and each chunk's
    rows written once: by its one segment, or by the fix-up of a split
    chunk whose partial rows are its segments. Raises ValueError."""
    ptr = layout.seg_ptr.cpu().numpy().astype(np.int64)
    tag = layout.seg_chunk.cpu().numpy().astype(np.int64)
    ss = layout.split_seg.cpu().numpy().astype(np.int64)
    koff = layout.chunk_koff.cpu().numpy().astype(np.int64)
    G = tag.size
    if ptr.shape != (G + 1,) or ss.ndim != 2 or ss.shape[0] != 3:
        raise ValueError("the segment table needs seg_ptr (G+1,), seg_chunk "
                         "(G,) and split_seg (3, K); build it with "
                         "segment_fields(chunk_koff, SUBLANES)")
    if ptr[0] != 0 or ptr[-1] != koff[-1] or (np.diff(ptr) < 1).any():
        raise ValueError("the segment table leaves slots of [0, "
                         f"{koff[-1]}) unwalked or walks one twice: seg_ptr "
                         "must rise strictly from 0 to chunk_koff[-1]")
    touched = -(-ptr[1:] // SUBLANES) - ptr[:-1] // SUBLANES
    if int(touched.max(initial=0)) > MAX_SEGMENT_SUBTILES:
        raise ValueError(
            f"a segment of {int(touched.max())} sub-tiles: the walk stages "
            f"the bases of at most {MAX_SEGMENT_SUBTILES}; build the table "
            "with segment_fields")
    split = (tag & SPLIT_BIT) != 0
    row_chunk = np.repeat(ss[0], ss[2] - ss[1])
    rows = tag[split] & ~SPLIT_BIT
    whole = tag[~split]
    if (rows.size != row_chunk.size
            or not np.array_equal(rows, np.arange(rows.size))
            or np.unique(whole).size != whole.size
            or np.isin(whole, ss[0]).any()
            or not np.array_equal(ss[1][1:], ss[2][:-1])
            or (ss.shape[1] and ss[1][0] != 0)):
        raise ValueError("seg_chunk and split_seg must write each chunk's "
                         "rows once: one whole segment, or the partial rows "
                         "of a split chunk, numbered in order")
    chunk = tag.copy()
    chunk[split] = row_chunk
    if ((chunk < 0) | (chunk >= layout.num_chunks)).any() or (
            (ptr[:-1] < koff[chunk]) | (ptr[1:] > koff[chunk + 1])).any():
        raise ValueError("a segment lies outside its chunk's slots")
    check_runs(layout.run_ptr, ptr)


def check_runs(run_ptr, ptr) -> None:
    """The run table's host check, over the segments' first slots ptr
    ((G+1,) int64; seg_ptr, or a RankedSlabs' seg_ptr * SUBLANES): runs
    of consecutive segments that cover all G in order, with their first
    slots, each touching at most the MAX_SEGMENT_SUBTILES sub-tiles and
    holding at most the MAX_RUN_SEGMENTS segments the walk stages.
    Raises ValueError."""
    G = ptr.size - 1
    run_ptr = run_ptr.cpu().numpy().astype(np.int64)
    runs = run_ptr[0] if run_ptr.ndim == 2 else run_ptr
    if run_ptr.ndim != 2 or run_ptr.shape[0] != 2 or runs.size < 2 or (
            runs[0] != 0 or runs[-1] != G or (np.diff(runs) < 1).any()
            or not np.array_equal(run_ptr[1], ptr[runs])):
        raise ValueError("run_ptr must be (2, R+1): segments rising strictly "
                         "from 0 to the segment count, and their first "
                         "slots; build it with run_fields")
    span = -(-ptr[runs[1:]] // SUBLANES) - ptr[runs[:-1]] // SUBLANES
    if int(span.max()) > MAX_SEGMENT_SUBTILES or int(
            np.diff(runs).max()) > MAX_RUN_SEGMENTS:
        raise ValueError(
            f"a run touches {int(span.max())} sub-tiles or holds "
            f"{int(np.diff(runs).max())} segments: the walk stages at most "
            f"{MAX_SEGMENT_SUBTILES} and {MAX_RUN_SEGMENTS}; build the "
            "table with run_fields")
