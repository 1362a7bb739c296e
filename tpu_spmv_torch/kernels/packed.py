"""Packed mixed-height SpMV: the CUDA kernel of csrc/packed.cu and its
plain PyTorch version.

`spmv_packed(layout, x)` replaces `tpu_spmv/kernels/packed.py:spmv_packed`
(delta and grouped bodies, and the out_row gather after them). On a CPU
tensor it runs `spmv_packed_reference`; on a CUDA tensor it launches the
kernel or raises. `spmv_packed.launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from tpu_spmv_torch.formats.packed import PackedRanked
from tpu_spmv_torch.formats.sell import LANES, SUBLANES
from tpu_spmv_torch.kernels import _build
from tpu_spmv_torch.kernels.sell import _LCOL_KIND, _VAL_KIND, ranked_bases


def spmv_packed_reference(layout: PackedRanked, x: torch.Tensor) -> torch.Tensor:
    """Plain version: every slot's product added into its chunk's row.

    Slot k belongs to the chunk c with chunk_koff[c] <= k < chunk_koff[c+1];
    slots past chunk_koff[num_chunks] map to num_chunks, a row that is
    dropped. x is (n,) or (n, B); y is (m,) or (m, B). A column outside
    [0, n) reads as 0."""
    n = layout.n
    slots = torch.arange(layout.vals.shape[0], device=x.device,
                         dtype=torch.int32)
    chunk = torch.searchsorted(layout.chunk_koff, slots, right=True) - 1
    cols = ranked_bases(layout).reshape(-1, 1) * LANES + layout.lcols.long()
    ok = (cols >= 0) & (cols < n)
    vals = layout.vals.float()
    if x.dim() == 2:
        ok, vals = ok[..., None], vals[..., None]
    prod = vals * torch.where(ok, x[cols.clamp(0, max(n - 1, 0))], 0.0)
    batch = tuple(x.shape[1:])
    y = torch.zeros(
        layout.num_chunks + 1, LANES, *batch, dtype=torch.float32,
        device=x.device,
    )
    y.index_add_(0, chunk, prod)
    return y[:-1].reshape(-1, *batch)[: layout.m]


def check_packed(layout: PackedRanked, what: str) -> None:
    """Shapes and types the packed kernels rely on (contents are trusted:
    reading them would synchronise with the card)."""
    if layout.chunk_koff.dtype != torch.int32 or (
        layout.chunk_koff.numel() != layout.num_chunks + 1
    ):
        raise ValueError(f"{what}: chunk_koff must be (num_chunks+1,) int32")
    if layout.num_chunks * LANES < layout.m:
        raise ValueError(f"{what}: fewer chunks than rows need")
    if layout.vals.shape != layout.lcols.shape or tuple(
        layout.vals.shape
    ) != (SUBLANES * layout.num_subtiles, LANES):
        raise ValueError(f"{what}: vals and lcols must be (8*S, 128)")
    if layout.vals.dtype not in _VAL_KIND:
        raise ValueError(f"{what}: unsupported vals dtype {layout.vals.dtype}")
    if layout.lcols.dtype not in _LCOL_KIND:
        raise ValueError(f"{what}: unsupported lcols dtype {layout.lcols.dtype}")
    G = layout.num_groups
    if G and layout.grp_b0.numel() != layout.num_subtiles * G:
        raise ValueError(f"{what}: grp_b0 must hold G bases per sub-tile")


def spmv_packed(layout: PackedRanked, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with A in packed mixed-height layout (grouped or not).
    x: (n,) float32 -> y: (m,) float32."""
    if x.device.type == "cpu":
        return spmv_packed_reference(layout, x)
    _build.check_operands(layout, x, "spmv_packed")
    check_packed(layout, "spmv_packed")
    y = torch.empty(layout.m, dtype=torch.float32, device=x.device)
    if layout.m == 0:
        return y
    rc = _build.library().tsp_spmv_packed(
        _VAL_KIND[layout.vals.dtype], _LCOL_KIND[layout.lcols.dtype],
        layout.vals.data_ptr(), layout.lcols.data_ptr(),
        layout.sub_b0.data_ptr(), layout.sub_dlo.data_ptr(),
        layout.sub_dhi.data_ptr(), layout.grp_b0.data_ptr(),
        layout.num_groups, layout.group_code & 0xFFFFFFFF,
        layout.chunk_koff.data_ptr(), x.data_ptr(), y.data_ptr(),
        layout.m, layout.n, _build.stream_of(x),
    )
    _build.check(rc, "spmv_packed")
    spmv_packed.launches += 1
    return y


spmv_packed.launches = 0
