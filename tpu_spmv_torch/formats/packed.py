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

The port adds one derived field, `chunk_koff` ((num_chunks+1,) int32):
chunk c's slots are [chunk_koff[c], chunk_koff[c+1]). A GPU thread that
owns a row sums that row's slots itself, so the TPU kernel's
cross-sub-tile carry, its two partial rows per sub-tile and the
`out_row` gather do not exist in the port. Slots past
chunk_koff[num_chunks] are padding and are never read.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_spmv_torch.formats.csr import CSRMatrix
from tpu_spmv_torch.formats.sell import (
    LANES,
    SUBLANES,
    TensorLayout,
    _aligned_slots,
    _binned_slots,
    _round_up,
    group_windows,
    pad_up_tile,
    to_tensor,
)

# Minimum slab height: bounds chunk ends per 8-slot sub-tile to two
# (consecutive ends are >= MIN_KC apart; a sub-tile spans 7 positions).
MIN_KC = 4


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
    m: int
    n: int
    nnz: int
    num_chunks: int
    rank_nb: int
    tile_k: int
    group_code: int = 0

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
