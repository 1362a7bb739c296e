"""A reduced planner for the port: `gpu_plan(mat, assume_rcm, spmm)`.

It keeps the structural tests of `tpu_spmv.tune.model.tpu_plan` and
none of its cost constants, which were measured on a TPU v5e:

  * DIA when the matrix passes both admission gates of
    `diagonal_profile` (a sampled probe first, then the exact scan);
    any reordering would break the constant diagonals, so needs_rcm is
    False;
  * otherwise packed or ranked, on cluster-aligned slots (bin_blocks 0;
    the binned widths wait for a calibrated planner). On an evenly
    spaced sample of at most 256 chunks, the ranked layout's sub-tiles
    (each chunk rounded up to whole 8-slot sub-tiles) are weighed
    against the packed layout's (chunks of max(kc, 4) slots back to
    back), and packed is taken when s_packed * R < s_ranked, with R the
    measured ratio of the two kernels that will run (PACKED_OVER_RANKED
    for SpMV, SPMM_PACKED_OVER_RANKED for SpMM), and x passes the
    residency gate (kernels/sell.resident_x_fits): the packed kernels
    have no windowed variant, so past the gate the plan is ranked, which
    the CLI then runs windowed (the reference planner's _packed_x_fits).
    The CLI falls back from packed to ranked, and from ranked to sell,
    when a build rejects a packed-delta span.

needs_rcm comes from the 95th-percentile row band (tpu_plan's estimate
without its sampled exact span, so the two can differ near the 8-block
threshold: general_1k estimates 8.4 blocks here, 8.0 exactly there, and
only the port reorders it).
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np

from tpu_spmv_torch.formats.csr import CSRMatrix
from tpu_spmv_torch.formats.dia import DIA_MAX_DIAGS, DIA_MAX_FILL, diagonal_profile
from tpu_spmv_torch.formats.packed import MIN_KC
from tpu_spmv_torch.formats.sell import LANES, SUBLANES, _aligned_slots

# Device time per walked sub-tile of spmv_packed over that of
# spmv_ranked, both grouped, on lap2d_1024 after RCM, warm (CUDA-graph
# timing): (15.21 us / 5122) / (18.48 us / 8192) = 1.317, measured by
# chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit,
# with both kernels on their segment walks (spmv_packed walking runs of
# segments, kernels/csrc/packed.cu). A packed sub-tile still costs more
# than a ranked one: its chunk ends fall inside sub-tiles, so a block
# walks a run of several short chunks with a store at each one's end,
# and the first and last sub-tile of a run are walked, predicated, by
# two blocks. Below 1.6 (ranked's 8-slot quantum over packed's 5 slots a
# chunk), packed is planned on lap2d_1024 after RCM.
PACKED_OVER_RANKED = 1.317
# The same ratio for SpMM (spmm_packed over spmm_ranked, B = 5 columns,
# the same matrix, card and timing, printed by chip_smoke.py):
# (32.56 us / 5122) / (50.32 us / 8192) = 1.035. spmm_ranked still gives
# a thread a row (kernels/csrc/slot_walk.cuh).
SPMM_PACKED_OVER_RANKED = 1.035

# tpu_plan's gate for its sampled slot statistics.
_MAX_ROW_FOR_SAMPLING = 2048


@dataclasses.dataclass(frozen=True)
class GpuPlan:
    kernel: str  # "dia", "packed" or "ranked"
    needs_rcm: bool
    reason: str
    bin_blocks: int = 0


def sample_chunks(mat, max_chunks: int = 256):
    """(submatrix of evenly spaced 128-row chunks, total/sampled chunks):
    tpu_spmv.tune.model._sample_chunks, whose module loads JAX when it
    runs. Slot assignment is per chunk, so sub-tile counts on the
    sample scale linearly."""
    m = mat.m
    num_chunks = max(-(-m // LANES), 1)
    if num_chunks <= max_chunks:
        return mat, 1.0
    pick = np.unique(
        np.linspace(0, num_chunks - 1, max_chunks).astype(np.int64)
    )
    indptr = [np.zeros(1, np.int64)]
    indices, data = [], []
    total = 0
    ip = mat.indptr.astype(np.int64)
    for c in pick:
        r0, r1 = c * LANES, min((c + 1) * LANES, m)
        e0, e1 = int(ip[r0]), int(ip[r1])
        indptr.append(ip[r0 + 1 : r1 + 1] - e0 + total)
        indices.append(mat.indices[e0:e1])
        data.append(mat.data[e0:e1])
        total += e1 - e0
        if r1 - r0 < LANES:  # tail chunk: keep 128-row framing via pad rows
            indptr.append(np.full(LANES - (r1 - r0), total, np.int64))
    sub = CSRMatrix(
        np.concatenate(indptr).astype(np.int32),
        np.concatenate(indices),
        np.concatenate(data).astype(np.float32),
        (pick.shape[0] * LANES, mat.n),
    )
    return sub, num_chunks / pick.shape[0]


def subtile_counts(kc) -> tuple:
    """(ranked, packed) sub-tiles for per-chunk slot counts kc: ranked
    rounds every chunk up to whole sub-tiles (at least one), packed
    stacks max(kc, MIN_KC) slots back to back."""
    kc = np.asarray(kc, np.int64)
    ranked = int(np.maximum((kc + SUBLANES - 1) // SUBLANES, 1).sum())
    packed = -(-int(np.maximum(kc, MIN_KC).sum()) // SUBLANES)
    return ranked, packed


def packed_x_fits(mat) -> bool:
    """resident_x_fits for a layout not built yet (the reference
    planner's _packed_x_fits): x of mat.n entries, plus one pair of guard
    blocks, against half of the L2 (hw.l2_bytes: the current card's,
    else the H100's)."""
    from tpu_spmv_torch.kernels.sell import resident_x_fits

    return resident_x_fits(types.SimpleNamespace(n=mat.n, vals=None))


def gpu_plan(mat, assume_rcm: bool = False, spmm: bool = False) -> GpuPlan:
    """The plan for y = A @ x, or with spmm for Y = A @ X: the packed
    candidate is weighed by PACKED_OVER_RANKED or SPMM_PACKED_OVER_RANKED,
    the ratio of the kernels that will run."""
    r = SPMM_PACKED_OVER_RANKED if spmm else PACKED_OVER_RANKED
    d_s, _ = diagonal_profile(mat, sample_rows=256)
    if d_s <= DIA_MAX_DIAGS:
        d, fill = diagonal_profile(mat)
        if d <= DIA_MAX_DIAGS and fill <= DIA_MAX_FILL:
            return GpuPlan(
                "dia", False,
                f"{d} constant diagonals, fill {fill:.2f}x — "
                "index-free DIA kernel",
            )
    bands = mat.row_bands()
    est_nb = (float(np.percentile(bands, 95)) + LANES) / LANES if mat.m else 1.0
    needs_rcm = not assume_rcm and est_nb > 8 and mat.m > LANES
    span = f"95th-percentile row span {est_nb:.0f} blocks"
    if mat.nnz and int(mat.row_lengths.max()) <= _MAX_ROW_FOR_SAMPLING:
        sampled, scale = sample_chunks(mat)
        s_ali, s_pk = subtile_counts(_aligned_slots(sampled)[1])
        s_ali, s_pk = s_ali * scale, s_pk * scale
        if s_pk * r < s_ali and not packed_x_fits(mat):
            return GpuPlan(
                "ranked", needs_rcm,
                f"aligned rank windows: packed would walk {s_pk:.0f} "
                f"sub-tiles x R={r:.2f} < {s_ali:.0f}, but "
                f"x is past the L2 residency gate and packed has no "
                f"windowed variant ({span})",
            )
        if s_pk * r < s_ali:
            return GpuPlan(
                "packed", needs_rcm,
                f"packed mixed-height slabs: {s_pk:.0f} sub-tiles x "
                f"R={r:.2f} < {s_ali:.0f} ranked ({span})",
            )
        return GpuPlan(
            "ranked", needs_rcm,
            f"aligned rank windows: {s_ali:.0f} sub-tiles <= {s_pk:.0f} "
            f"packed x R={r:.2f} ({span})",
        )
    return GpuPlan("ranked", needs_rcm, f"aligned rank windows ({span})")
