"""Lower-triangular solve over a pack-scheduled SELL layout (counterpart
of `tpu_spmv/sts/solve.py`).

The host layout is the reference's, array for array:

  * rows are laid out pack by pack, each pack padded to 128-row chunks
    (a chunk never straddles a pack boundary);
  * strict-L is stored as SELL slabs over the padded rows, values
    pre-scaled by 1/diag (a division-free solve);
  * the rank-windowed RankedSlabs is kept when its windows stay within
    RANKED_SOLVE_MAX_NB blocks; otherwise the column-binned candidates
    W in {2, 4, 8} are weighed by the reference's sub-tile cost and the
    cheapest is kept; when none builds, the plain SellSlabs solve runs.

The device solve differs: the TPU kernels rely on a grid that runs in
order on one core, while the port's kernels (kernels/sts.py,
csrc/sts.cu) order the chunks themselves with a ticket and per-chunk
ready flags. The layout adds what the plain versions need on the host:
the chunk range of each pack (from `sys.pack_ptr` and the padding) and
the sub-tile range that goes with it, for the slabs and for the ranked
layout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_spmv_torch.formats.csr import CSRMatrix
from tpu_spmv_torch.formats.sell import (
    LANES, RankedSlabs, SellSlabs, TensorLayout, to_tensor,
)
from tpu_spmv_torch.kernels.sts import (
    lower_solve_blocks, lower_solve_blocks_reference, lower_solve_ranked,
    lower_solve_ranked_reference, solve_steps,
)
from tpu_spmv_torch.sts.host import TriangularSystem

# Rank-windowed solve: the reference's static gather-iteration cap.
RANKED_SOLVE_MAX_NB = 8

# The reference's sub-tile cost for choosing a binned width
# (tpu_spmv/tune/model.py:_ranked_subtile_cost with its defaults,
# _RANKED_FIXED, _PAIR_COST and _TRAFFIC_FLOOR). These are TPU v5e
# constants, kept so both packages choose the same layout; calling the
# reference's function would load JAX through its calibration lookup,
# which on a CPU returns these same defaults. A cost measured on the
# H100 is ROADMAP item A6.
_RANKED_FIXED = 3.3
_PAIR_COST = 0.95
_TRAFFIC_FLOOR = 1.7
_BIN_WIDTHS = (2, 4, 8)


def ranked_subtile_cost(rank_nb: int) -> float:
    pairs = max((rank_nb + 1) // 2, 1)
    return max(_RANKED_FIXED + _PAIR_COST * pairs, _TRAFFIC_FLOOR)


def _round_up_arr(a: np.ndarray, mult: int) -> np.ndarray:
    return -(-a // mult) * mult


@dataclasses.dataclass
class LowerSolveLayout(TensorLayout):
    """Tensors for the chunk-ordered lower solve, plus host schedules.

    slab_steps / ranked_steps: (P + 1, 2) int64 host arrays, the chunk
    and sub-tile boundaries of each pack for `slabs` and `ranked`
    (kernels.sts.solve_steps); only the plain versions read them.

    Known cost (the reference's note): every pack pads to a 128-row
    chunk, so level schedules with many tiny levels inflate slab storage
    and work by up to 128x against COLOR on the same matrix.
    """

    slabs: SellSlabs  # strict-L (scaled) over padded rows
    b_scale: torch.Tensor  # (num_chunks+1, 128) b * inv_diag, padded
    inv_diag: torch.Tensor  # (num_chunks+1, 128) for re-scaling new b
    pad_index: torch.Tensor  # (m,) int32 padded position of each real row
    m: int
    slab_steps: np.ndarray
    ranked: RankedSlabs | None = None  # when the rank windows are narrow
    ranked_steps: np.ndarray | None = None

    @property
    def num_packs(self) -> int:
        return self.slab_steps.shape[0] - 1

    @property
    def kernel(self) -> str:
        """The solve `lower_solve` runs: "ranked" or "blocks"."""
        return "blocks" if self.ranked is None else "ranked"

    @classmethod
    def build(
        cls, sys: TriangularSystem, b: np.ndarray, ranked: bool = True,
    ) -> "LowerSolveLayout":
        """Build from a host TriangularSystem and right-hand side b (both
        in the system's permuted row order). ranked=False skips the
        rank-windowed search and always runs the blocks solve."""
        L = sys.lower
        m = L.m
        lens = L.row_lengths
        if not np.all(lens >= 1):
            raise ValueError("lower factor has an empty row (missing diagonal)")
        # Columns ascend, so the diagonal is each row's last entry.
        diag_pos = L.indptr[1:].astype(np.int64) - 1
        diag = L.data[diag_pos]
        if np.any(diag == 0.0):
            raise ValueError("zero diagonal entry; system is singular")
        inv_diag = (1.0 / diag).astype(np.float32)

        # Padded row numbering: each pack padded to a multiple of 128.
        pack_sizes = np.diff(sys.pack_ptr)
        padded_sizes = np.maximum(_round_up_arr(pack_sizes, LANES), LANES)
        pad_start = np.zeros(sys.num_packs + 1, dtype=np.int64)
        np.cumsum(padded_sizes, out=pad_start[1:])
        m_pad = int(pad_start[-1])
        row_pack = np.repeat(np.arange(sys.num_packs, dtype=np.int64), pack_sizes)
        pad_index = pad_start[row_pack] + (
            np.arange(m, dtype=np.int64) - sys.pack_ptr[row_pack]
        )

        # Strict lower (drop the diagonal), values scaled by the owning
        # row's inv_diag, columns remapped to padded positions.
        keep = np.ones(L.nnz, dtype=bool)
        keep[diag_pos] = False
        rows = np.repeat(np.arange(m, dtype=np.int64), lens)[keep]
        cols = pad_index[L.indices[keep].astype(np.int64)]
        vals = (L.data[keep].astype(np.float64) * inv_diag[rows]).astype(np.float32)
        s_indptr = np.zeros(m_pad + 1, dtype=np.int64)
        np.add.at(s_indptr, pad_index[rows] + 1, 1)
        np.cumsum(s_indptr, out=s_indptr)
        strictL = CSRMatrix(
            s_indptr.astype(np.int32), cols.astype(np.int32), vals,
            (m_pad, m_pad),
        )
        slabs = SellSlabs.from_csr(strictL)

        # Rank windows when the static gather loop stays short; otherwise
        # the column-binned candidates, cheapest by the reference's cost.
        want_ranked = ranked
        ranked = None
        if want_ranked:
            try:
                cand = RankedSlabs.from_csr(strictL)
                if cand.rank_nb <= RANKED_SOLVE_MAX_NB:
                    ranked = cand
            except ValueError:
                pass  # packed-delta range exceeded: scattered dependencies
        if want_ranked and ranked is None and strictL.nnz:
            best = None
            for w in _BIN_WIDTHS:
                try:
                    cand = RankedSlabs.from_csr(strictL, bin_blocks=w)
                except ValueError:
                    continue
                cost = cand.num_subtiles * ranked_subtile_cost(cand.rank_nb)
                if best is None or cost < best[0]:
                    best = (cost, cand)
            if best is not None:
                ranked = best[1]

        num_chunks = slabs.num_chunks
        bpad = np.zeros((num_chunks + 1) * LANES, dtype=np.float32)
        dpad = np.zeros((num_chunks + 1) * LANES, dtype=np.float32)
        bpad[pad_index] = np.asarray(b, dtype=np.float32) * inv_diag
        dpad[pad_index] = inv_diag
        pack_chunk_ptr = pad_start // LANES
        return cls(
            slabs=slabs,
            b_scale=to_tensor(bpad.reshape(num_chunks + 1, LANES)),
            inv_diag=to_tensor(dpad.reshape(num_chunks + 1, LANES)),
            pad_index=to_tensor(pad_index.astype(np.int32)),
            m=m,
            slab_steps=solve_steps(slabs.chunk_ptr, pack_chunk_ptr),
            ranked=ranked,
            ranked_steps=(None if ranked is None
                          else solve_steps(ranked.chunk_ptr, pack_chunk_ptr)),
        )


def lower_solve(layout: LowerSolveLayout,
                b_scale: torch.Tensor | None = None,
                plain: bool = False) -> torch.Tensor:
    """Solve L x = b. b_scale overrides the layout's scaled right-hand
    side ((num_chunks+1, 128), = b_padded * inv_diag). Returns x (m,) in
    the system's permuted row order, on b_scale's device. plain=True
    runs the plain PyTorch version on any device (for comparison with
    the kernel on the card)."""
    if b_scale is None:
        b_scale = layout.b_scale
    if layout.ranked is not None:
        fn = lower_solve_ranked_reference if plain else lower_solve_ranked
        x_pad = fn(layout.ranked, b_scale, layout.ranked_steps)
    else:
        fn = lower_solve_blocks_reference if plain else lower_solve_blocks
        x_pad = fn(layout.slabs, b_scale, layout.slab_steps)
    return x_pad.reshape(-1).index_select(0, layout.pad_index)


def lower_solve_reference(sys: TriangularSystem, b: np.ndarray) -> np.ndarray:
    """Serial forward substitution oracle in float64 (the reference's
    lower_solve_reference, copied)."""
    L = sys.lower
    x = np.zeros(L.m, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    indptr, indices, data = L.indptr, L.indices, L.data.astype(np.float64)
    for i in range(L.m):
        s, e = indptr[i], indptr[i + 1]
        acc = 0.0
        for j in range(s, e - 1):
            acc += data[j] * x[indices[j]]
        x[i] = (b[i] - acc) / data[e - 1]
    return x


def lower_solve_layout_from_jax(jax_layout, sys: TriangularSystem | None = None
                                ) -> LowerSolveLayout:
    """The port's layout for a JAX-package LowerSolveLayout (its arrays
    read through NumPy; JAX is never imported). With `sys`, the system
    it was built from, the plain versions step pack by pack; without,
    chunk by chunk."""
    from tpu_spmv_torch.formats.convert import from_reference

    slabs = from_reference(jax_layout.slabs)
    ranked = (None if jax_layout.ranked is None
              else from_reference(jax_layout.ranked))
    pack_chunk_ptr = None
    if sys is not None:
        padded = np.maximum(_round_up_arr(np.diff(sys.pack_ptr), LANES), LANES)
        pack_chunk_ptr = np.concatenate([[0], np.cumsum(padded // LANES)])
    return LowerSolveLayout(
        slabs=slabs,
        b_scale=to_tensor(jax_layout.b_scale),
        inv_diag=to_tensor(jax_layout.inv_diag),
        pad_index=to_tensor(jax_layout.pad_index),
        m=jax_layout.m,
        slab_steps=solve_steps(slabs.chunk_ptr, pack_chunk_ptr),
        ranked=ranked,
        ranked_steps=(None if ranked is None
                      else solve_steps(ranked.chunk_ptr, pack_chunk_ptr)),
    )


__all__ = [
    "LowerSolveLayout", "RANKED_SOLVE_MAX_NB", "lower_solve",
    "lower_solve_blocks", "lower_solve_layout_from_jax",
    "lower_solve_reference", "ranked_subtile_cost",
]
