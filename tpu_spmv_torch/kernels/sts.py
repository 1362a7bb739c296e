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
kernels sum each row's slots in slot order (sub-tile, then sublane)
with one fused multiply-add a slot, then subtract from b_scale. The
plain versions (`*_reference`) repeat that arithmetic exactly, so a
kernel and its plain version give the same bits: they walk the
dependency steps in order and, per step, gather x at the slots of its
chunks' sub-tiles, place each chunk's products slot by slot, and fold
them into the chunk's rows one slot at a time with a single rounding
each (`_fma_rn`), then x[chunks] = b_scale - acc, in NumPy on the host
(the same IEEE bits as the card's, at a fraction of torch's per-call
cost on small arrays).
A step is a run of chunks whose rows are mutually independent: one pack
of the schedule (`steps` from `solve_steps(chunk_ptr, pack_chunk_ptr)`),
or one chunk when no schedule is given. The kernels need no steps: each
row of x is its own ready flag (csrc/sts.cu). They still require the
slabs' wait table (formats/sell.wait_fields, which LowerSolveLayout.build
fills), which the solve's cost model and choice read
(sts/solve.solve_cost).

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor
it launches the kernel or raises (a layout without a wait table
raises). `<wrapper>.launches` counts kernel launches. `counts=` (an
int64 tensor of 3 on the card, added to) launches the counting
instantiation instead: the slots read, the first reads that found a row
unsolved, and the re-reads those took (bench/solve_times.py).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_spmv_torch.formats.sell import LANES, SUBLANES, RankedSlabs, SellSlabs
from tpu_spmv_torch.kernels import _build
from tpu_spmv_torch.kernels.sell import _LCOL_KIND, delta_bases


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


def _fma_rn(p: np.ndarray, acc: np.ndarray) -> np.ndarray:
    """float32 RN(p + acc) with one rounding, p a float64 product of two
    float32 values (exact in float64): the kernels' __fmaf_rn. The sum
    is rounded to odd in float64 (53 >= 24 + 2 bits), so rounding that
    to float32 rounds the exact sum once."""
    c = acc.astype(np.float64)
    s = p + c
    t = s - p
    # The exact error of the sum (TwoSum); NaN where s is not finite.
    e = (p - (s - t)) + (c - t)
    bits = s.view(np.int64)
    # An inexact sum with an even last bit steps one unit toward e.
    inexact_even = ((e < 0) | (e > 0)) & ((bits & 1) == 0)
    toward = np.where((e > 0) == (s > 0), 1, -1)
    return (bits + np.where(inexact_even, toward, 0)).view(
        np.float64).astype(np.float32)


def _solve_plain(vals, cols_of, chunk_ptr, b_scale, steps, x_blocks):
    """x blocks of (x_blocks, 128), step by step, in the kernels'
    arithmetic, on the host in NumPy (IEEE float32 and float64, the
    card's bits) and returned on b_scale's device. cols_of(s0, s1) gives
    the (s1 - s0, 8, 128) int64 columns of sub-tiles s0..s1. A step's
    products are placed by (chunk, slot of the chunk) and folded into
    the chunks' rows one slot at a time. A padding slot (value 0) that
    points at an earlier chunk of the same step reads 0 here, where the
    kernels read that chunk's solved row: the same bits unless that row
    is inf or NaN. Stepping chunk by chunk (steps=None) gives the
    kernels' bits for any x."""
    v = vals.cpu().numpy().reshape(-1, SUBLANES, LANES)
    cp = chunk_ptr.cpu().numpy().astype(np.int64)
    b = b_scale.cpu().numpy().reshape(-1)
    x = np.zeros(x_blocks * LANES, np.float32)
    for (c0, s0), (c1, s1) in zip(steps[:-1].tolist(), steps[1:].tolist()):
        if c1 == c0:
            continue
        lens = np.diff(cp[c0:c1 + 1])
        k = int(lens.max()) if lens.size else 0
        acc = np.zeros((c1 - c0, LANES), np.float32)
        if k:
            cols = cols_of(s0, s1).cpu().numpy()
            slots = np.zeros(((c1 - c0) * k, SUBLANES, LANES))
            # Sub-tile s of chunk c goes to row (c - c0) * k + (s - cp[c]).
            place = (np.repeat(np.arange(c1 - c0) * k - cp[c0:c1], lens)
                     + np.arange(s0, s1))
            with np.errstate(invalid="ignore"):
                slots[place] = v[s0:s1].astype(np.float64) * x[cols]
                slots = slots.reshape(c1 - c0, k * SUBLANES, LANES)
                # A slot whose products are all 0 leaves acc as it is
                # (acc is never -0), so only the others are folded.
                for j in np.flatnonzero(slots.any(axis=(0, 2))):
                    acc = _fma_rn(slots[:, j], acc)
        r0, r1 = c0 * LANES, c1 * LANES
        x[r0:r1] = b[r0:r1] - acc.reshape(-1)
    return torch.from_numpy(x).to(b_scale.device).view(x_blocks, LANES)


def lower_solve_blocks_reference(slabs: SellSlabs, b_scale: torch.Tensor,
                                 steps=None) -> torch.Tensor:
    """Plain version over absolute columns."""
    if steps is None:
        steps = solve_steps(slabs.chunk_ptr)
    cols = slabs.cols.view(-1, SUBLANES, LANES)
    return _solve_plain(
        slabs.vals, lambda s0, s1: cols[s0:s1].long(), slabs.chunk_ptr,
        b_scale, steps, slabs.num_chunks + 1,
    )


def lower_solve_ranked_reference(ranked: RankedSlabs, b_scale: torch.Tensor,
                                 steps=None) -> torch.Tensor:
    """Plain version: col = 128 * (sub_b0 + packed delta) + lcols. The
    deltas are read even for a grouped layout (they hold its group
    bases), as the kernels do."""
    if steps is None:
        steps = solve_steps(ranked.chunk_ptr)
    bases = delta_bases(ranked)
    lcols = ranked.lcols.view(-1, SUBLANES, LANES)
    return _solve_plain(
        ranked.vals,
        lambda s0, s1: bases[s0:s1, :, None] * LANES + lcols[s0:s1].long(),
        ranked.chunk_ptr, b_scale, steps,
        ranked.num_chunks + 1 + ranked.rank_nb,
    )


def _check(layout, b_scale: torch.Tensor, what: str) -> None:
    """What both kernels require: b_scale float32 (num_chunks + 1, 128),
    contiguous, on a CUDA device, with every layout tensor contiguous on
    that device; float32 values; chunk_ptr (num_chunks + 1,) int32; and
    the wait table, which the kernels do not read but the solve's cost
    model does (a layout without one was not built for a solve)."""
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
    if layout.wait_ptr is None:
        raise ValueError(
            f"{what}: layout has no wait table (wait_ptr); build it with "
            "sts.solve.LowerSolveLayout.build or lower_solve_layout_from_jax "
            "(formats.sell.wait_fields)"
        )
    # Their values were checked on the host when the container was made
    # (formats/sell._check_tables).
    if (layout.wait_ptr.dtype != torch.int32
            or layout.wait_chunk.dtype != torch.int32
            or layout.wait_ptr.numel() != layout.num_chunks + 1
            or layout.wait_chunk.dim() != 1):
        raise ValueError(f"{what}: the wait table must be int32 wait_ptr "
                         "(num_chunks+1,) and wait_chunk (W,)")


def _output(x_blocks: int, device) -> tuple:
    """x, (x_blocks, 128) float32, and its buffer, one int32 word longer:
    the ticket. The C entry sets the chunks' rows to the sentinel and
    zeroes the rows past them and the ticket, on the launch stream; the
    kernel writes every chunk's rows."""
    buf = torch.empty(x_blocks * LANES + 1, dtype=torch.float32,
                      device=device)
    return buf[:-1].view(x_blocks, LANES), buf


def _counters(counts, b_scale: torch.Tensor) -> int:
    """The counter array's pointer for the C entry: 0 (the solvers'
    instantiation) or an int64 (3,) tensor on b_scale's device."""
    if counts is None:
        return 0
    if (counts.dtype != torch.int64 or tuple(counts.shape) != (3,)
            or counts.device != b_scale.device):
        raise ValueError("counts must be int64 of shape (3,) on b_scale's "
                         "device")
    return counts.data_ptr()


def lower_solve_blocks(slabs: SellSlabs, b_scale: torch.Tensor,
                       steps=None, *, counts=None) -> torch.Tensor:
    """Solve over strict-L SellSlabs; returns x as (num_chunks + 1, 128)
    padded blocks. steps is read by the plain version only; counts (on
    the card only) launches the counting instantiation (module doc)."""
    if b_scale.device.type == "cpu":
        return lower_solve_blocks_reference(slabs, b_scale, steps)
    _check(slabs, b_scale, "lower_solve_blocks")
    if slabs.cols.dtype != torch.int32:
        raise ValueError("lower_solve_blocks: cols must be int32")
    C = slabs.num_chunks
    x, buf = _output(C + 1, b_scale.device)
    rc = _build.library().tsp_lower_solve_blocks(
        slabs.vals.data_ptr(), slabs.cols.data_ptr(),
        slabs.chunk_ptr.data_ptr(), b_scale.data_ptr(), buf.data_ptr(),
        _counters(counts, b_scale), C, C + 1, _build.stream_of(b_scale),
    )
    _build.check(rc, "lower_solve_blocks")
    lower_solve_blocks.launches += 1
    return x


def lower_solve_ranked(ranked: RankedSlabs, b_scale: torch.Tensor,
                       steps=None, *, counts=None) -> torch.Tensor:
    """Solve over strict-L RankedSlabs; returns x as
    (num_chunks + 1 + rank_nb, 128) padded blocks. steps is read by the
    plain version only; counts as lower_solve_blocks'."""
    if b_scale.device.type == "cpu":
        return lower_solve_ranked_reference(ranked, b_scale, steps)
    _check(ranked, b_scale, "lower_solve_ranked")
    if ranked.lcols.dtype not in _LCOL_KIND:
        raise ValueError(
            f"lower_solve_ranked: unsupported lcols dtype {ranked.lcols.dtype}"
        )
    C = ranked.num_chunks
    x_blocks = C + 1 + ranked.rank_nb
    x, buf = _output(x_blocks, b_scale.device)
    rc = _build.library().tsp_lower_solve_ranked(
        _LCOL_KIND[ranked.lcols.dtype], ranked.vals.data_ptr(),
        ranked.lcols.data_ptr(), ranked.sub_b0.data_ptr(),
        ranked.sub_dlo.data_ptr(), ranked.sub_dhi.data_ptr(),
        ranked.chunk_ptr.data_ptr(), b_scale.data_ptr(), buf.data_ptr(),
        _counters(counts, b_scale), C, x_blocks, _build.stream_of(b_scale),
    )
    _build.check(rc, "lower_solve_ranked")
    lower_solve_ranked.launches += 1
    return x


lower_solve_blocks.launches = 0
lower_solve_ranked.launches = 0
