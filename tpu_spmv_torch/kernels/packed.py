"""Packed mixed-height SpMV and SpMM: the CUDA kernel of csrc/packed.cu
and its plain PyTorch version.

`spmv_packed(layout, x)` replaces `tpu_spmv/kernels/packed.py:spmv_packed`
(delta and grouped bodies, and the out_row gather after them); the same
walk, compiled per width, serves `kernels/spmm.spmm_packed` and, over a
RankedSlabs' segment and run tables, `kernels/spmm.spmm_ranked`
(`launch_packed`). On a CPU tensor it runs `spmv_packed_reference`; on a
CUDA tensor it launches the kernel or raises. `spmv_packed.launches`
counts calls that launched the kernel, once per call: a call is one
device launch, or two on a layout with a split chunk (the segment walk,
then the fix-up that adds its segments' partial rows).
"""

from __future__ import annotations

import torch

from tpu_spmv_torch.formats.packed import PackedRanked
from tpu_spmv_torch.formats.sell import LANES, SUBLANES, RankedSlabs
from tpu_spmv_torch.kernels import _build
from tpu_spmv_torch.kernels.sell import (
    _LCOL_KIND, _VAL_KIND, _check_slabs, _segment_args, ranked_bases,
)


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


def check_packed(layout, what: str) -> None:
    """Shapes and types the packed walk relies on besides the segment
    table's, which kernels/sell._segment_args checks (contents are
    trusted: reading them would synchronise with the card; the container
    checked its tables on the host when it was made), for a PackedRanked
    or a RankedSlabs (its chunk_ptr in place of chunk_koff)."""
    if isinstance(layout, RankedSlabs):
        _check_slabs(layout, what)
    elif layout.chunk_koff.dtype != torch.int32 or (
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


def launch_packed(layout, x: torch.Tensor, what: str,
                  matrix: bool = False) -> torch.Tensor:
    """Checks, then csrc/packed.cu's tsp_packed for x (n,) or, with
    matrix, X (n, B) on the card: the walk of the run table into y (m,)
    or Y (m, B), one launch per group of at most 8 columns, then the
    fix-up of the split chunks' partial rows when the layout has any.
    layout: a PackedRanked, or a RankedSlabs, whose segment table counts
    sub-tiles (seg_shift 3) and whose packed deltas hold its bases even
    when grouped (G = 0)."""
    _build.check_operands(layout, x, what, matrix=matrix)
    check_packed(layout, what)
    ranked = isinstance(layout, RankedSlabs)
    B = x.shape[1] if matrix else 1
    seg_ptr, seg_chunk, _, split_seg, nsplit, part = _segment_args(
        layout, x, what, B)
    run_ptr = layout.run_ptr
    if run_ptr.dtype != torch.int32 or run_ptr.dim() != 2 or (
            run_ptr.shape[0] != 2):
        raise ValueError(f"{what}: run_ptr must be (2, R+1) int32")
    y = torch.empty(layout.m, *x.shape[1:], dtype=torch.float32,
                    device=x.device)
    if layout.m == 0:
        return y
    rc = _build.library().tsp_packed(
        _VAL_KIND[layout.vals.dtype], _LCOL_KIND[layout.lcols.dtype],
        layout.vals.data_ptr(), layout.lcols.data_ptr(),
        layout.sub_b0.data_ptr(), layout.sub_dlo.data_ptr(),
        layout.sub_dhi.data_ptr(), layout.grp_b0.data_ptr(),
        0 if ranked else layout.num_groups, layout.group_code & 0xFFFFFFFF,
        seg_ptr, 3 if ranked else 0, seg_chunk, run_ptr.data_ptr(),
        run_ptr.shape[1] - 1, split_seg, nsplit, x.data_ptr(), y.data_ptr(),
        part.data_ptr(), layout.m, layout.n, B, _build.stream_of(x),
    )
    _build.check(rc, what)
    return y


def packed_launches(layout, batch: int = 1) -> int:
    """Device launches of one call of the packed walk (spmv_packed,
    spmm_packed, spmm_ranked): one per group of at most 8 columns, plus
    the split fix-up when a chunk is split."""
    return -(-batch // 8) + (layout.split_seg.shape[1] > 0)


def spmv_packed(layout: PackedRanked, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with A in packed mixed-height layout (grouped or not).
    x: (n,) float32 -> y: (m,) float32."""
    if x.device.type == "cpu":
        return spmv_packed_reference(layout, x)
    y = launch_packed(layout, x, "spmv_packed")
    spmv_packed.launches += 1
    return y


spmv_packed.launches = 0
