"""Chunk-ordered lower-triangular solve: the CUDA kernels of csrc/sts.cu
and their plain PyTorch versions.

Counterpart of the two Pallas kernels of `tpu_spmv/sts/solve.py`:

  lower_solve_blocks  replaces lower_solve_blocks (_make_solve_kernel):
                      SellSlabs with absolute int32 columns; returns x
                      as (num_chunks + 1, 128) padded blocks;
  lower_solve_ranked  replaces _lower_solve_ranked
                      (_make_ranked_solve_kernel): RankedSlabs, bases
                      from sub_b0 and the packed deltas; returns
                      (num_chunks + 1 + rank_nb, 128) blocks.

Both solve x[c] = b_scale[c] - sum(val * x[col]) over chunk c's slots,
chunk after chunk (see tpu_spmv_torch/sts/solve.py for the layout). The
plain versions (`*_reference`) walk the dependency steps in order: per
step, a gather of x at the slots of its chunks' sub-tiles, a sum per
sub-tile, an accumulating `index_put_` into the chunks, then
x[chunks] = b_scale - acc.
A step is a run of chunks whose rows are mutually independent: one pack
of the schedule (`steps` from `solve_steps(chunk_ptr, pack_chunk_ptr)`),
or one chunk when no schedule is given. The kernel needs no steps.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor
it launches the kernel or raises. `<wrapper>.launches` counts kernel
launches.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_spmv_torch.formats.sell import LANES, SUBLANES, RankedSlabs, SellSlabs
from tpu_spmv_torch.kernels import _build
from tpu_spmv_torch.kernels.sell import _LCOL_KIND, ranked_bases


def solve_steps(chunk_ptr, pack_chunk_ptr=None) -> np.ndarray:
    """(P + 1, 2) int64 host array: the chunk and sub-tile boundaries of
    the P dependency steps. pack_chunk_ptr (P + 1,) gives each pack's
    chunk range; None makes every chunk a step of its own."""
    if isinstance(chunk_ptr, torch.Tensor):
        chunk_ptr = chunk_ptr.cpu().numpy()
    cp = np.asarray(chunk_ptr, np.int64)
    pc = (np.arange(cp.shape[0], dtype=np.int64) if pack_chunk_ptr is None
          else np.asarray(pack_chunk_ptr, np.int64))
    return np.stack([pc, cp[pc]], 1)


def _solve_plain(vals, cols_of, sub_chunk, b_scale, steps, x_blocks):
    """x blocks of (x_blocks, 128), step by step. cols_of(s0, s1) gives
    the (s1 - s0, 8, 128) int64 columns of sub-tiles s0..s1. Graph-
    capturable: the loop bounds are host integers. The gather is
    index_select and the sum index_put_(accumulate=True): on the CPU,
    advanced indexing and index_add_ open a thread-pool region per call,
    and thousands of those stall for seconds when several processes
    share the cores."""
    dev = b_scale.device
    v = vals.view(-1, SUBLANES, LANES)
    owner = sub_chunk.long()
    b = b_scale.reshape(-1)
    x = torch.zeros(x_blocks * LANES, dtype=torch.float32, device=dev)
    for (c0, s0), (c1, s1) in zip(steps[:-1].tolist(), steps[1:].tolist()):
        if c1 == c0:
            continue
        xg = x.index_select(0, cols_of(s0, s1).reshape(-1))
        part = (v[s0:s1] * xg.view(-1, SUBLANES, LANES)).sum(1)
        acc = torch.zeros(c1 - c0, LANES, dtype=torch.float32, device=dev)
        acc.index_put_((owner[s0:s1] - c0,), part, accumulate=True)
        r0, r1 = c0 * LANES, c1 * LANES
        x[r0:r1] = b[r0:r1] - acc.reshape(-1)
    return x.view(x_blocks, LANES)


def lower_solve_blocks_reference(slabs: SellSlabs, b_scale: torch.Tensor,
                                 steps=None) -> torch.Tensor:
    """Plain version over absolute columns."""
    if steps is None:
        steps = solve_steps(slabs.chunk_ptr)
    cols = slabs.cols.view(-1, SUBLANES, LANES)
    return _solve_plain(
        slabs.vals, lambda s0, s1: cols[s0:s1].long(), slabs.sub_chunk,
        b_scale, steps, slabs.num_chunks + 1,
    )


def lower_solve_ranked_reference(ranked: RankedSlabs, b_scale: torch.Tensor,
                                 steps=None) -> torch.Tensor:
    """Plain version: col = 128 * (sub_b0 + packed delta) + lcols. The
    deltas are read even for a grouped layout (they hold its group
    bases), as the kernels do."""
    if steps is None:
        steps = solve_steps(ranked.chunk_ptr)
    bases = ranked_bases(dataclasses.replace(ranked, group_code=0))
    lcols = ranked.lcols.view(-1, SUBLANES, LANES)
    return _solve_plain(
        ranked.vals,
        lambda s0, s1: bases[s0:s1, :, None] * LANES + lcols[s0:s1].long(),
        ranked.sub_chunk, b_scale, steps,
        ranked.num_chunks + 1 + ranked.rank_nb,
    )


def _check(layout, b_scale: torch.Tensor, what: str) -> None:
    """What both kernels require: b_scale float32 (num_chunks + 1, 128),
    contiguous, on a CUDA device, with every layout tensor contiguous on
    that device; float32 values; chunk_ptr (num_chunks + 1,) int32."""
    if b_scale.device.type != "cuda":
        raise ValueError(f"{what}: b_scale is on {b_scale.device}, not a "
                         "CUDA device")
    want = (layout.num_chunks + 1, LANES)
    if b_scale.dtype != torch.float32 or tuple(b_scale.shape) != want:
        raise ValueError(
            f"{what}: b_scale must be float32 of shape {want}, got "
            f"{b_scale.dtype} {tuple(b_scale.shape)}"
        )
    if not b_scale.is_contiguous():
        raise ValueError(f"{what}: b_scale must be contiguous")
    for name, t in layout.tensors().items():
        if t.device != b_scale.device:
            raise ValueError(f"{what}: layout.{name} is on {t.device}, "
                             f"b_scale on {b_scale.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: layout.{name} must be contiguous")
    if layout.vals.dtype != torch.float32:
        raise ValueError(f"{what}: vals must be float32")
    if layout.chunk_ptr.dtype != torch.int32 or (
        layout.chunk_ptr.numel() != layout.num_chunks + 1
    ):
        raise ValueError(f"{what}: chunk_ptr must be (num_chunks+1,) int32")


def _outputs(num_chunks: int, x_blocks: int, device):
    """x and the flags (ready per chunk, then the ticket); the C entry
    zeroes both on the launch stream."""
    return (
        torch.empty(x_blocks, LANES, dtype=torch.float32, device=device),
        torch.empty(num_chunks + 1, dtype=torch.int32, device=device),
    )


def lower_solve_blocks(slabs: SellSlabs, b_scale: torch.Tensor,
                       steps=None) -> torch.Tensor:
    """Solve over strict-L SellSlabs; returns x as (num_chunks + 1, 128)
    padded blocks. steps is read by the plain version only."""
    if b_scale.device.type == "cpu":
        return lower_solve_blocks_reference(slabs, b_scale, steps)
    _check(slabs, b_scale, "lower_solve_blocks")
    if slabs.cols.dtype != torch.int32:
        raise ValueError("lower_solve_blocks: cols must be int32")
    C = slabs.num_chunks
    x, flags = _outputs(C, C + 1, b_scale.device)
    rc = _build.library().tsp_lower_solve_blocks(
        slabs.vals.data_ptr(), slabs.cols.data_ptr(),
        slabs.chunk_ptr.data_ptr(), b_scale.data_ptr(), x.data_ptr(),
        flags.data_ptr(), C, C + 1, _build.stream_of(b_scale),
    )
    _build.check(rc, "lower_solve_blocks")
    lower_solve_blocks.launches += 1
    return x


def lower_solve_ranked(ranked: RankedSlabs, b_scale: torch.Tensor,
                       steps=None) -> torch.Tensor:
    """Solve over strict-L RankedSlabs; returns x as
    (num_chunks + 1 + rank_nb, 128) padded blocks. steps is read by the
    plain version only."""
    if b_scale.device.type == "cpu":
        return lower_solve_ranked_reference(ranked, b_scale, steps)
    _check(ranked, b_scale, "lower_solve_ranked")
    if ranked.lcols.dtype not in _LCOL_KIND:
        raise ValueError(
            f"lower_solve_ranked: unsupported lcols dtype {ranked.lcols.dtype}"
        )
    C = ranked.num_chunks
    x_blocks = C + 1 + ranked.rank_nb
    x, flags = _outputs(C, x_blocks, b_scale.device)
    rc = _build.library().tsp_lower_solve_ranked(
        _LCOL_KIND[ranked.lcols.dtype], ranked.vals.data_ptr(),
        ranked.lcols.data_ptr(), ranked.sub_b0.data_ptr(),
        ranked.sub_dlo.data_ptr(), ranked.sub_dhi.data_ptr(),
        ranked.chunk_ptr.data_ptr(), b_scale.data_ptr(), x.data_ptr(),
        flags.data_ptr(), C, x_blocks, _build.stream_of(b_scale),
    )
    _build.check(rc, "lower_solve_ranked")
    lower_solve_ranked.launches += 1
    return x


lower_solve_blocks.launches = 0
lower_solve_ranked.launches = 0
