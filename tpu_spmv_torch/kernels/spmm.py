"""Multi-vector SpMV (SpMM, Y = A @ X): the CUDA kernels of csrc/packed.cu
and csrc/windowed.cu and their plain PyTorch versions.

Counterpart of `tpu_spmv/kernels/spmm.py`:

  spmm_ranked           replaces spmm_ranked (RankedSlabs) and its
                        per-column segment-sum of partials: the run walk
                        of spmv_packed (csrc/packed.cu) over the ranked
                        layout's segment table (in sub-tiles) and run
                        table (formats/packed.ranked_walk_fields), with
                        the packed-delta bases, which hold a grouped
                        layout's too; one launch per group of at most 8
                        columns, each group's width compiled in, plus the
                        split fix-up;
  spmm_ranked_windowed  replaces spmm_ranked_windowed, the route for an X
                        past `resident_x_fits(layout, batch=B)`: the
                        segment walk of spmv_ranked_windowed over a ring
                        of X blocks (128 rows, B columns) in shared
                        memory, one launch per group of at most 8
                        columns, each group's width compiled in (the CLI
                        cuts the window table's step, then the columns
                        into passes of B', until the ring fits);
  spmm_packed           replaces spmm_packed (PackedRanked, delta and
                        grouped bases) and its out_row gather: the
                        segment walk of spmv_packed (csrc/packed.cu),
                        one launch per group of at most 8 columns, each
                        group's width compiled in, plus the split fix-up.

X is (n, B) float32, row-major, any B >= 1; Y is (m, B) float32. On a
CPU tensor each runs its plain version (the single-vector plain
versions with an (n, B) gather); on a CUDA tensor it launches the
kernel or raises. `<wrapper>.launches` counts calls that launched the
kernel, once per call. Each is an eager entry (obs.entry: its call span
and the launchers' entry.check / entry.alloc / entry.launch steps while
a profiler records), as the SpMV wrappers are.
"""

from __future__ import annotations

import torch

from tpu_spmv_torch import obs
from tpu_spmv_torch.formats.packed import PackedRanked
from tpu_spmv_torch.formats.sell import RankedSlabs
from tpu_spmv_torch.kernels.packed import launch_packed, spmv_packed_reference
from tpu_spmv_torch.kernels.sell import (
    launch_ranked_windowed, spmv_ranked_reference,
    spmv_ranked_windowed_reference,
)


def spmm_ranked_reference(layout: RankedSlabs, X: torch.Tensor) -> torch.Tensor:
    """Plain version: spmv_ranked_reference over the B columns at once."""
    return spmv_ranked_reference(layout, X)


def spmm_ranked_windowed_reference(layout: RankedSlabs,
                                   X: torch.Tensor) -> torch.Tensor:
    """Plain version: spmv_ranked_windowed_reference over the B columns
    at once."""
    return spmv_ranked_windowed_reference(layout, X)


def spmm_packed_reference(layout: PackedRanked, X: torch.Tensor) -> torch.Tensor:
    """Plain version: spmv_packed_reference over the B columns at once."""
    return spmv_packed_reference(layout, X)


@obs.entry
def spmm_ranked(layout: RankedSlabs, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X with A in rank-windowed SELL layout (grouped or not)."""
    if X.device.type == "cpu":
        return spmm_ranked_reference(layout, X)
    Y = launch_packed(layout, X, "spmm_ranked", matrix=True)
    spmm_ranked.launches += 1
    return Y


@obs.entry
def spmm_ranked_windowed(layout: RankedSlabs, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X with X staged in shared memory, a ring of ring_blocks
    blocks of 128 rows and B columns filled a step ahead; same results
    as spmm_ranked. Raises ValueError when the ring exceeds the card's
    shared memory (kernels/sell.check_window)."""
    if X.device.type == "cpu":
        return spmm_ranked_windowed_reference(layout, X)
    Y = launch_ranked_windowed(layout, X, "spmm_ranked_windowed")
    spmm_ranked_windowed.launches += 1
    return Y


@obs.entry
def spmm_packed(layout: PackedRanked, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X with A in packed mixed-height layout (grouped or not)."""
    if X.device.type == "cpu":
        return spmm_packed_reference(layout, X)
    Y = launch_packed(layout, X, "spmm_packed", matrix=True)
    spmm_packed.launches += 1
    return Y


spmm_ranked.launches = 0
spmm_ranked_windowed.launches = 0
spmm_packed.launches = 0
