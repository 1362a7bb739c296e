"""Lower-triangular solve over a pack-scheduled SELL layout (counterpart
of `tpu_spmv/sts/solve.py`).

The host layout is the reference's, array for array:

  * rows are laid out pack by pack, each pack padded to 128-row chunks
    (a chunk never straddles a pack boundary);
  * strict-L is stored as SELL slabs over the padded rows, values
    pre-scaled by 1/diag (a division-free solve);
  * the rank-windowed RankedSlabs is kept when its windows stay within
    RANKED_SOLVE_MAX_NB blocks; otherwise the column-binned candidates
    W in {2, 4, 8} are weighed by the planner's sub-tile cost
    (tune/model._ranked_subtile_cost, on the card's calibration) and the
    cheapest is kept; when none builds, the plain SellSlabs solve runs.

Which of the two kernels `lower_solve` runs is the port's own choice
(`LowerSolveLayout.kernel`, solve_choice): without the card's solve
constants (the solve_* keys of hw.kernel_calibration) the reference's,
ranked whenever it is built; with them, blocks where its chain costs
SOLVE_MARGIN less than the ranked one's (solve_cost). A kernel solves a
chunk in rounds of SOLVE_GROUP sub-tiles, each one gather round trip
after the chunk's waits, so a chunk costs a link plus its rounds, and
the solve costs its longest chain of chunks through the wait table.

The device solve differs: the TPU kernels rely on a grid that runs in
order on one core, while the port's kernels (kernels/sts.py,
csrc/sts.cu) order the chunks themselves with a ticket, and each row of
x is its own ready flag (a sentinel until it is solved). The layout adds
what each side needs: the wait table of the slabs and of the ranked
layout (formats/sell.wait_fields: the earlier chunks each chunk reads,
the chain solve_cost walks), and on the host, for the plain versions,
the chunk range of each pack (from `sys.pack_ptr` and the padding) and
the sub-tile range that goes with it.

The builders build for the card unless asked for another device
(`device="cpu"` for the plain versions), and raise without one
(hw.target_device).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_spmv_torch.formats.csr import CSRMatrix
from tpu_spmv_torch.formats.sell import (
    LANES, RankedSlabs, SellSlabs, TensorLayout, to_tensor, wait_fields,
)
from tpu_spmv_torch.hw import target_device
from tpu_spmv_torch.kernels.sts import (
    lower_solve_blocks, lower_solve_blocks_reference, lower_solve_ranked,
    lower_solve_ranked_reference, solve_steps,
)
from tpu_spmv_torch.sts.host import TriangularSystem
from tpu_spmv_torch.tune.model import _ranked_subtile_cost

# Rank-windowed solve: the reference's static gather-iteration cap.
RANKED_SOLVE_MAX_NB = 8

# Sub-tiles a solve kernel reads in one gather round (kGroup, csrc/sts.cu).
SOLVE_GROUP = 2
# The blocks solve replaces a built ranked one only when its chain costs
# this much less. On chunks of one sub-tile solve_cost misses by more
# than 5%: on lap2d_1024 LS it prices the ranked chain 4-6% above the
# blocks one, where an H100 times the ranked solve 1% faster (1,089.60
# against 1,099.52 us).
SOLVE_MARGIN = 0.10

# The column-bin widths weighed when the rank windows are too wide
# (tpu_spmv/sts/solve.py:158-169), each by tune.model's sub-tile cost,
# which reads the current card's calibration (hw.kernel_calibration): the
# card's measured constants on the card, the caller's
# ($TPU_SPMV_TORCH_CALIB) or the module defaults without one.
_BIN_WIDTHS = (2, 4, 8)


def _round_up_arr(a: np.ndarray, mult: int) -> np.ndarray:
    return -(-a // mult) * mult


def solve_constants() -> dict | None:
    """{kernel: (link, round)} of both solve kernels from the card's
    calibration (solve_<kernel>_link and solve_<kernel>_round, in its
    unit), or None when the entry lacks any of them."""
    from tpu_spmv_torch.tune.model import _cal

    out = {}
    for kernel in ("ranked", "blocks"):
        pair = tuple(_cal(f"solve_{kernel}_{part}", -1.0)
                     for part in ("link", "round"))
        if min(pair) < 0:
            return None
        out[kernel] = pair
    return out


def solve_cost(slabs, link: float, per_round: float) -> float:
    """The longest chain of chunks through the slabs' wait table, each
    chunk costing link + per_round * its rounds (ceil(sub-tiles /
    SOLVE_GROUP)): what one solve kernel takes on this layout."""
    cp = np.asarray(slabs.chunk_ptr.cpu().numpy(), np.int64)
    weight = (link + per_round * -(-np.diff(cp) // SOLVE_GROUP)).tolist()
    ptr = slabs.wait_ptr.cpu().numpy().tolist()
    waits = slabs.wait_chunk.cpu().numpy().tolist()
    done = [0.0] * len(weight)
    for c, w in enumerate(weight):
        a, b = ptr[c], ptr[c + 1]
        done[c] = w + (max([done[j] for j in waits[a:b]]) if b > a else 0.0)
    return max(done, default=0.0)


def solve_choice(slabs, ranked) -> str:
    """The kernel lower_solve runs on these slabs and ranked layout (both
    with their wait tables; ranked None: not built) under the current
    calibration (module doc)."""
    if ranked is None:
        return "blocks"
    consts = solve_constants()
    if consts is not None and solve_cost(slabs, *consts["blocks"]) < (
            1.0 - SOLVE_MARGIN) * solve_cost(ranked, *consts["ranked"]):
        return "blocks"
    return "ranked"


def _with_waits(slabs):
    """The slabs (SellSlabs, RankedSlabs or None) with their wait table."""
    return (None if slabs is None
            else dataclasses.replace(slabs, **wait_fields(slabs)))


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
    # "blocks" when the calibration finds the blocks solve cheaper than a
    # ranked layout that was built.
    solve: str = "ranked"

    @property
    def num_packs(self) -> int:
        return self.slab_steps.shape[0] - 1

    @property
    def kernel(self) -> str:
        """The solve `lower_solve` runs: "ranked" or "blocks"."""
        return "blocks" if self.ranked is None else self.solve

    @classmethod
    def build(
        cls, sys: TriangularSystem, b: np.ndarray, ranked: bool = True,
        device=None,
    ) -> "LowerSolveLayout":
        """Build from a host TriangularSystem and right-hand side b (both
        in the system's permuted row order), on `device` (default: the
        card; raises without one, hw.target_device). ranked=False skips
        the rank-windowed search and always runs the blocks solve."""
        device = target_device(device)
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
                cost = cand.num_subtiles * _ranked_subtile_cost(cand.rank_nb)
                if best is None or cost < best[0]:
                    best = (cost, cand)
            if best is not None:
                ranked = best[1]

        slabs, ranked = _with_waits(slabs), _with_waits(ranked)

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
            solve=solve_choice(slabs, ranked),
        ).to(device)


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
    if layout.kernel == "ranked":
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


def lower_solve_layout_from_jax(jax_layout, sys: TriangularSystem | None = None,
                                device=None) -> LowerSolveLayout:
    """The port's layout for a JAX-package LowerSolveLayout (its arrays
    read through NumPy; JAX is never imported), with the wait tables
    derived from its slabs, on `device` as LowerSolveLayout.build places
    it. With `sys`, the system it was built from, the plain versions
    step pack by pack; without, chunk by chunk."""
    from tpu_spmv_torch.formats.convert import from_reference

    device = target_device(device)
    slabs = _with_waits(from_reference(jax_layout.slabs))
    ranked = (None if jax_layout.ranked is None
              else _with_waits(from_reference(jax_layout.ranked)))
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
    ).to(device)


__all__ = [
    "LowerSolveLayout", "RANKED_SOLVE_MAX_NB", "SOLVE_GROUP", "lower_solve",
    "lower_solve_blocks", "lower_solve_layout_from_jax",
    "lower_solve_reference", "solve_choice", "solve_constants", "solve_cost",
]
