"""A reduced planner for the port: `gpu_plan(mat, assume_rcm)`.

It keeps the structural tests of `tpu_spmv.tune.model.tpu_plan` and
none of its cost constants, which were measured on a TPU v5e:

  * DIA when the matrix passes both admission gates of
    `diagonal_profile` (a sampled probe first, then the exact scan);
    any reordering would break the constant diagonals, so needs_rcm is
    False;
  * otherwise ranked, with needs_rcm from the 95th-percentile row band
    (tpu_plan's estimate without its sampled exact span, so the two can
    differ near the 8-block threshold: general_1k estimates 8.4 blocks
    here, 8.0 exactly there, and only the port reorders it). The CLI
    falls back to sell when the ranked build rejects a packed-delta
    span.

A planner with constants measured on the H100 is later work.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpu_spmv_torch.formats.dia import DIA_MAX_DIAGS, DIA_MAX_FILL, diagonal_profile
from tpu_spmv_torch.formats.sell import LANES


@dataclasses.dataclass(frozen=True)
class GpuPlan:
    kernel: str  # "dia" or "ranked"
    needs_rcm: bool
    reason: str


def gpu_plan(mat, assume_rcm: bool = False) -> GpuPlan:
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
    return GpuPlan(
        "ranked", needs_rcm,
        f"aligned rank windows (95th-percentile row span {est_nb:.0f} blocks)",
    )
