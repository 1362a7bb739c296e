"""Multi-vector SpMV (SpMM, Y = A @ X): the CUDA kernels of csrc/spmm.cu
and csrc/windowed.cu and their plain PyTorch versions.

Counterpart of `tpu_spmv/kernels/spmm.py`:

  spmm_ranked           replaces spmm_ranked (RankedSlabs) and its
                        per-column segment-sum of partials;
  spmm_ranked_windowed  replaces spmm_ranked_windowed, the route for an X
                        past `resident_x_fits(layout, batch=B)`: the
                        segment walk of spmv_ranked_windowed over a ring
                        of X blocks (128 rows, B columns) in shared
                        memory, one launch per group of at most 8
                        columns, each group's width compiled in (the CLI
                        cuts the window table's step, then the columns
                        into passes of B', until the ring fits);
  spmm_packed           replaces spmm_packed (PackedRanked, delta and
                        grouped bases) and its out_row gather.

X is (n, B) float32, row-major, any B >= 1; Y is (m, B) float32. On a
CPU tensor each runs its plain version (the single-vector plain
versions with an (n, B) gather); on a CUDA tensor it launches the
kernel or raises. `<wrapper>.launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from tpu_spmv_torch.formats.packed import PackedRanked
from tpu_spmv_torch.formats.sell import RankedSlabs
from tpu_spmv_torch.kernels import _build
from tpu_spmv_torch.kernels.packed import check_packed, spmv_packed_reference
from tpu_spmv_torch.kernels.sell import (
    _LCOL_KIND, _VAL_KIND, _check_slabs, launch_ranked_windowed,
    spmv_ranked_reference, spmv_ranked_windowed_reference,
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


def _empty_y(layout, X: torch.Tensor) -> torch.Tensor:
    return torch.empty(
        layout.m, X.shape[1], dtype=torch.float32, device=X.device
    )


def spmm_ranked(layout: RankedSlabs, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X with A in rank-windowed SELL layout (grouped or not; the
    kernel reads the packed-delta bases, which hold the grouped ones)."""
    if X.device.type == "cpu":
        return spmm_ranked_reference(layout, X)
    _build.check_operands(layout, X, "spmm_ranked", matrix=True)
    _check_slabs(layout, "spmm_ranked")
    if layout.vals.dtype not in _VAL_KIND:
        raise ValueError(f"spmm_ranked: unsupported vals dtype {layout.vals.dtype}")
    if layout.lcols.dtype not in _LCOL_KIND:
        raise ValueError(
            f"spmm_ranked: unsupported lcols dtype {layout.lcols.dtype}"
        )
    Y = _empty_y(layout, X)
    if layout.m == 0:
        return Y
    rc = _build.library().tsp_spmm_ranked(
        _VAL_KIND[layout.vals.dtype], _LCOL_KIND[layout.lcols.dtype],
        layout.vals.data_ptr(), layout.lcols.data_ptr(),
        layout.sub_b0.data_ptr(), layout.sub_dlo.data_ptr(),
        layout.sub_dhi.data_ptr(), layout.chunk_ptr.data_ptr(),
        X.data_ptr(), Y.data_ptr(), layout.m, layout.n, X.shape[1],
        _build.stream_of(X),
    )
    _build.check(rc, "spmm_ranked")
    spmm_ranked.launches += 1
    return Y


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


def spmm_packed(layout: PackedRanked, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X with A in packed mixed-height layout (grouped or not)."""
    if X.device.type == "cpu":
        return spmm_packed_reference(layout, X)
    _build.check_operands(layout, X, "spmm_packed", matrix=True)
    check_packed(layout, "spmm_packed")
    Y = _empty_y(layout, X)
    if layout.m == 0:
        return Y
    rc = _build.library().tsp_spmm_packed(
        _VAL_KIND[layout.vals.dtype], _LCOL_KIND[layout.lcols.dtype],
        layout.vals.data_ptr(), layout.lcols.data_ptr(),
        layout.sub_b0.data_ptr(), layout.sub_dlo.data_ptr(),
        layout.sub_dhi.data_ptr(), layout.grp_b0.data_ptr(),
        layout.num_groups, layout.group_code & 0xFFFFFFFF,
        layout.chunk_koff.data_ptr(), X.data_ptr(), Y.data_ptr(),
        layout.m, layout.n, X.shape[1], _build.stream_of(X),
    )
    _build.check(rc, "spmm_packed")
    spmm_packed.launches += 1
    return Y


spmm_ranked.launches = 0
spmm_ranked_windowed.launches = 0
spmm_packed.launches = 0
