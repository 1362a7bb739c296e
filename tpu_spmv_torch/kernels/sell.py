"""SELL-slab SpMV: the CUDA kernels of csrc/sell.cu and their plain
PyTorch versions.

Counterpart of `tpu_spmv/kernels/pallas_sell.py`:

  spmv_ranked  replaces spmv_ranked (ungrouped and grouped bodies) and
               its _reduce_partials epilogue;
  spmv_sell    replaces spmv_sell and its epilogue.

On a CPU tensor each runs its plain version (`*_reference`: a gather,
a reshape-sum over the 8 slots of each sub-tile, then `index_add_` of
the sub-tile sums into their chunks); on a CUDA tensor it launches the
kernel or raises. `<wrapper>.launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from tpu_spmv_torch.formats.sell import LANES, SUBLANES, RankedSlabs, SellSlabs
from tpu_spmv_torch.kernels import _build

_VAL_KIND = {torch.float32: 0, torch.bfloat16: 1}
_LCOL_KIND = {torch.uint8: 0, torch.int16: 1, torch.int32: 2}


def ranked_bases(layout: RankedSlabs) -> torch.Tensor:
    """(S, 8) int64 x-block base of every (sub-tile, sublane) window."""
    if layout.group_code:
        # Column slices, not an index tensor: no host-to-device copy, so
        # the plain version can be captured in a CUDA graph for timing.
        per_group = layout.grp_b0.view(-1, layout.num_groups).long()
        return torch.stack([per_group[:, g] for g in layout.groups], 1)
    shifts = torch.arange(0, 32, 8, device=layout.sub_b0.device)
    # int32 view of uint32: mask back to unsigned before shifting.
    lo = (layout.sub_dlo.long() & 0xFFFFFFFF)[:, None] >> shifts
    hi = (layout.sub_dhi.long() & 0xFFFFFFFF)[:, None] >> shifts
    return layout.sub_b0.long()[:, None] + (torch.cat([lo, hi], 1) & 255)


def _slab_spmv(layout, cols: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y from (S, 8, 128) absolute columns: per-sub-tile sums, then the
    sub-tile sums added into their chunks (the sentinel tail lands in
    the dropped last row)."""
    n = layout.n
    S = layout.num_subtiles
    ok = (cols >= 0) & (cols < n)
    xg = torch.where(ok, x[cols.clamp(0, max(n - 1, 0))], 0.0)
    part = (layout.vals.view(S, SUBLANES, LANES).float() * xg).sum(1)
    y = torch.zeros(
        layout.num_chunks + 1, LANES, dtype=torch.float32, device=x.device
    )
    y.index_add_(0, layout.sub_chunk.long(), part)
    return y[:-1].reshape(-1)[: layout.m]


def spmv_ranked_reference(layout: RankedSlabs, x: torch.Tensor) -> torch.Tensor:
    """Plain version: col = 128 * base(s, r) + lcols."""
    S = layout.num_subtiles
    cols = ranked_bases(layout)[:, :, None] * LANES + layout.lcols.view(
        S, SUBLANES, LANES
    ).long()
    return _slab_spmv(layout, cols, x)


def spmv_sell_reference(layout: SellSlabs, x: torch.Tensor) -> torch.Tensor:
    """Plain version over the absolute columns."""
    cols = layout.cols.view(layout.num_subtiles, SUBLANES, LANES).long()
    return _slab_spmv(layout, cols, x)


def _check_slabs(layout, what: str) -> None:
    if layout.chunk_ptr.dtype != torch.int32 or (
        layout.chunk_ptr.numel() != layout.num_chunks + 1
    ):
        raise ValueError(f"{what}: chunk_ptr must be (num_chunks+1,) int32")
    if layout.num_chunks * LANES < layout.m:
        raise ValueError(f"{what}: fewer chunks than rows need")


def spmv_ranked(layout: RankedSlabs, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with A in rank-windowed SELL layout (grouped or not).
    x: (n,) float32 -> y: (m,) float32."""
    if x.device.type == "cpu":
        return spmv_ranked_reference(layout, x)
    _build.check_operands(layout, x, "spmv_ranked")
    _check_slabs(layout, "spmv_ranked")
    if layout.vals.dtype not in _VAL_KIND:
        raise ValueError(f"spmv_ranked: unsupported vals dtype {layout.vals.dtype}")
    if layout.lcols.dtype not in _LCOL_KIND:
        raise ValueError(
            f"spmv_ranked: unsupported lcols dtype {layout.lcols.dtype}"
        )
    G = layout.num_groups
    if G and layout.grp_b0.numel() != layout.num_subtiles * G:
        raise ValueError("spmv_ranked: grp_b0 must hold G bases per sub-tile")
    y = torch.empty(layout.m, dtype=torch.float32, device=x.device)
    if layout.m == 0:
        return y
    rc = _build.library().tsp_spmv_ranked(
        _VAL_KIND[layout.vals.dtype], _LCOL_KIND[layout.lcols.dtype],
        layout.vals.data_ptr(), layout.lcols.data_ptr(),
        layout.sub_b0.data_ptr(), layout.sub_dlo.data_ptr(),
        layout.sub_dhi.data_ptr(), layout.grp_b0.data_ptr(), G,
        layout.group_code & 0xFFFFFFFF, layout.chunk_ptr.data_ptr(),
        x.data_ptr(), y.data_ptr(), layout.m, layout.n,
        _build.stream_of(x),
    )
    _build.check(rc, "spmv_ranked")
    spmv_ranked.launches += 1
    return y


def spmv_sell(layout: SellSlabs, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with A in SELL layout (absolute columns).
    x: (n,) float32 -> y: (m,) float32."""
    if x.device.type == "cpu":
        return spmv_sell_reference(layout, x)
    _build.check_operands(layout, x, "spmv_sell")
    _check_slabs(layout, "spmv_sell")
    if layout.vals.dtype != torch.float32 or layout.cols.dtype != torch.int32:
        raise ValueError("spmv_sell: vals must be float32 and cols int32")
    y = torch.empty(layout.m, dtype=torch.float32, device=x.device)
    if layout.m == 0:
        return y
    rc = _build.library().tsp_spmv_sell(
        layout.vals.data_ptr(), layout.cols.data_ptr(),
        layout.chunk_ptr.data_ptr(), x.data_ptr(), y.data_ptr(),
        layout.m, layout.n, _build.stream_of(x),
    )
    _build.check(rc, "spmv_sell")
    spmv_sell.launches += 1
    return y


spmv_ranked.launches = 0
spmv_sell.launches = 0
