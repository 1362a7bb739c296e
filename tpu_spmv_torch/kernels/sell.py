"""SELL-slab SpMV: the CUDA kernels of csrc/sell.cu and csrc/windowed.cu
and their plain PyTorch versions.

Counterpart of `tpu_spmv/kernels/pallas_sell.py`:

  spmv_ranked           replaces spmv_ranked (ungrouped and grouped
                        bodies) and its _reduce_partials epilogue;
  spmv_ranked_windowed  replaces spmv_ranked_windowed, the route for an
                        x past `resident_x_fits`: the same segment walk
                        over a ring of x blocks in shared memory, filled
                        a step ahead (formats/sell.window_fields);
  spmv_sell             replaces spmv_sell and its epilogue.

On a CPU tensor each runs its plain version (`*_reference`: a gather,
a reshape-sum over the 8 slots of each sub-tile, then `index_add_` of
the sub-tile sums into their chunks); on a CUDA tensor it launches the
kernel or raises. All three walk the layout's segment table
(formats/sell.segment_fields) in the same order of summation, so
spmv_ranked_windowed gives spmv_ranked's bits on one layout.
`<wrapper>.launches` counts calls that launched the kernel, once per
call: a call is one device launch, or two on a layout with split chunks
(the walk, then the fix-up that adds their segments' partial rows), and
an SpMM through the ring walks its columns in groups of at most 8, one
launch each. `spmv_ranked(layout, x, out=y)` adds A @ x into y in place
(the accumulate mode of the walk, one pass of kernels/striped.py).
"""

from __future__ import annotations

import torch

from tpu_spmv_torch import hw, obs
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
    return delta_bases(layout)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def resident_x_fits(layout, budget_frac: float = 0.5, batch: int = 1) -> bool:
    """True when the padded x (batch columns of it, for an SpMM) fits
    budget_frac of the L2 of the card the layout lies on (hw.l2_bytes:
    the H100's 50 MB off the card, or when the layout's values are not
    a tensor): then the resident kernels' gathers stay in L2. Otherwise
    the CLIs take the windowed kernels.

    The reference (tpu_spmv/kernels/pallas_sell.py:resident_x_fits) also
    charges the double-buffered slab tiles and partials that its kernels
    hold in VMEM. No GPU kernel here holds slab tiles or partials in L2
    between uses, so only x is charged."""
    reads_nb = 2 * max((getattr(layout, "rank_nb", 1) + 1) // 2, 1)
    n_pad = _round_up(max(layout.n, LANES), LANES) + max(
        reads_nb, getattr(layout, "max_nb", 1)
    ) * LANES
    device = getattr(layout.vals, "device", None)
    return 4 * n_pad * batch <= budget_frac * hw.l2_bytes(device)


# Static shared memory of a CTA of the ring walk: its four mbarriers
# (csrc/windowed.cu).
RING_STATIC_BYTES = 32


def _align128(b: int) -> int:
    return _round_up(b, 128)


def window_bytes(layout: RankedSlabs, batch: int = 1) -> int:
    """Shared memory of one CTA of the windowed kernels
    (formats/sell.window_fields; csrc/windowed.cu's Stage): the ring of
    ring_blocks blocks of 128 rows of x, batch columns wide, two stages of
    stage_subtiles sub-tiles' slabs (values and local columns, 1024 slots
    each) and window bases (sub_b0 and the two delta words, 4 more
    sub-tiles each for alignment), and the mbarriers."""
    cap = layout.stage_subtiles
    slots = cap * SUBLANES * LANES
    stage = (_align128(slots * layout.vals.element_size())
             + _align128(slots * layout.lcols.element_size())
             + 3 * _align128((cap + 4) * 4))
    return (_align128(layout.ring_blocks * LANES * batch * 4) + 2 * stage
            + RING_STATIC_BYTES)


def check_window(layout: RankedSlabs, batch: int = 1,
                 budget: int | None = None) -> None:
    """Raise ValueError when the layout has no window table or its ring,
    batch columns wide, exceeds `budget` bytes of shared memory
    (default: what a block may use on the current card, hw.smem_per_block).
    The counterpart of the VMEM refusal of tpu_spmv/kernels/dia.py:206."""
    if layout.step_seg is None or layout.ring_blocks <= 0:
        raise ValueError(
            "layout has no window table (step_seg); build it with "
            "RankedSlabs.from_csr or formats.convert.from_reference"
        )
    budget = hw.smem_per_block() if budget is None else budget
    need = window_bytes(layout, batch)
    if need > budget:
        raise ValueError(
            f"windowed x ring of {layout.ring_blocks} blocks x {batch} "
            f"column(s) and stages of {layout.stage_subtiles} sub-tiles = "
            f"{need} bytes, beyond the {budget}-byte shared-memory budget; "
            "cut the window table at a smaller step (RankedSlabs.with_steps) "
            "or split the columns"
        )


def delta_bases(layout: RankedSlabs) -> torch.Tensor:
    """(S, 8) int64 window base per (sub-tile, sublane) from the packed
    deltas alone, as the windowed kernels read it: grouped layouts carry
    their group's base in the deltas too."""
    shifts = torch.arange(0, 32, 8, device=layout.sub_b0.device)
    # int32 view of uint32: mask back to unsigned before shifting.
    lo = (layout.sub_dlo.long() & 0xFFFFFFFF)[:, None] >> shifts
    hi = (layout.sub_dhi.long() & 0xFFFFFFFF)[:, None] >> shifts
    return layout.sub_b0.long()[:, None] + (torch.cat([lo, hi], 1) & 255)


def _subtile_sums(layout, xg: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y from the (S, 8, 128[, B]) gathered x values: per-sub-tile sums,
    then the sub-tile sums added into their chunks (the sentinel tail
    lands in the dropped last row). y is (m,) or (m, B)."""
    S = layout.num_subtiles
    vals = layout.vals.view(S, SUBLANES, LANES).float()
    if x.dim() == 2:
        vals = vals[..., None]
    part = (vals * xg).sum(1)
    batch = tuple(x.shape[1:])
    y = torch.zeros(
        layout.num_chunks + 1, LANES, *batch, dtype=torch.float32,
        device=x.device,
    )
    y.index_add_(0, layout.sub_chunk.long(), part)
    return y[:-1].reshape(-1, *batch)[: layout.m]


def _slab_spmv(layout, cols: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y from (S, 8, 128) absolute columns. x is (n,) or (n, B)."""
    n = layout.n
    ok = (cols >= 0) & (cols < n)
    if x.dim() == 2:
        ok = ok[..., None]
    xg = torch.where(ok, x[cols.clamp(0, max(n - 1, 0))], 0.0)
    return _subtile_sums(layout, xg, x)


def spmv_ranked_reference(layout: RankedSlabs, x: torch.Tensor) -> torch.Tensor:
    """Plain version: col = 128 * base(s, r) + lcols."""
    S = layout.num_subtiles
    cols = ranked_bases(layout)[:, :, None] * LANES + layout.lcols.view(
        S, SUBLANES, LANES
    ).long()
    return _slab_spmv(layout, cols, x)


def spmv_ranked_windowed_reference(layout: RankedSlabs,
                                   x: torch.Tensor) -> torch.Tensor:
    """Plain version of the windowed kernels, for x (n,) or X (n, B):
    each slot of a walked sub-tile reads its step's range [step_lo,
    step_hi) of x (formats/sell.window_fields) at (base(s, r) - step_lo)
    * 128 + lcols, and 0 where that falls outside the range (the
    kernel's predicate) or past x (the kernel's zero rows); then the sums
    of spmv_ranked_reference. The all-pad tail, which no step walks,
    reads 0. No host sync, so a CUDA graph can capture it for timing."""
    S = layout.num_subtiles
    T = layout.step_lo.numel()
    dev = x.device
    bounds = layout.seg_ptr.long()[layout.step_seg.long()]  # (T+1,)
    step = torch.searchsorted(bounds, torch.arange(S, device=dev),
                              right=True) - 1
    walked = (step < T)[:, None, None]
    step = step.clamp(max=T - 1)
    first = layout.step_lo.long()[step][:, None, None]
    width = ((layout.step_hi.long() - layout.step_lo.long())[step]
             * LANES)[:, None, None]
    local = (delta_bases(layout)[:, :, None] - first) * LANES + (
        layout.lcols.view(S, SUBLANES, LANES).long())
    rows = first * LANES + local
    inside = walked & (local >= 0) & (local < width) & (rows < layout.n)
    xg = x[rows.clamp(0, max(layout.n - 1, 0))]
    if x.dim() == 2:
        inside = inside[..., None]
    return _subtile_sums(layout, torch.where(inside, xg, 0.0), x)


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


def partial_rows(layout) -> int:
    """Rows of 128 floats of the partials scratch of one call: one per
    segment of a split chunk, G - num_chunks + K, as every other chunk
    has one segment."""
    return (layout.seg_chunk.numel() - layout.num_chunks
            + layout.split_seg.shape[1])


def _segment_args(layout, x: torch.Tensor, what: str, batch: int = 1,
                  part: torch.Tensor | None = None) -> tuple:
    """Checks of the segment table, then the walk's arguments: seg_ptr,
    seg_chunk, the segment count G, split_seg, the split-chunk count K
    and the floats of the partials scratch (partial_rows rows of 128 x
    batch; `part`, when given, must hold at least that many), which
    _scratch allocates."""
    seg_ptr = getattr(layout, "seg_ptr", None)
    if seg_ptr is None:
        raise ValueError(
            f"{what}: layout has no segment table (seg_ptr); build it with "
            "from_csr or formats.convert.from_reference"
        )
    G = layout.seg_chunk.numel()
    if (seg_ptr.dtype != torch.int32 or seg_ptr.numel() != G + 1
            or layout.seg_chunk.dtype != torch.int32
            or layout.split_seg.dtype != torch.int32
            or layout.split_seg.dim() != 2 or layout.split_seg.shape[0] != 3):
        raise ValueError(
            f"{what}: the segment table must be int32 seg_ptr (G+1,), "
            "seg_chunk (G,) and split_seg (3, K)"
        )
    K = layout.split_seg.shape[1]
    need = partial_rows(layout) * LANES * batch
    if part is not None and (
            part.dtype != torch.float32 or part.device != x.device
            or not part.is_contiguous() or part.numel() < need):
        raise ValueError(f"{what}: part must be a contiguous float32 "
                         f"scratch of at least {need} on {x.device}")
    return (seg_ptr.data_ptr(), layout.seg_chunk.data_ptr(), G,
            layout.split_seg.data_ptr(), K, need)


def _scratch(need: int, x: torch.Tensor,
             part: torch.Tensor | None = None) -> torch.Tensor:
    """The partials scratch of a call: `part` when given (checked by
    _segment_args), else `need` new floats on x's device."""
    if part is not None:
        return part
    return torch.empty(need, dtype=torch.float32, device=x.device)


def ranked_walk_args(layout: RankedSlabs, x: torch.Tensor, what: str,
                     out: torch.Tensor | None = None,
                     part: torch.Tensor | None = None) -> tuple:
    """The checks of a ranked walk on the card, then (y, args): y (`out`
    when given, else new) and the C arguments of tsp_spmv_ranked (and of
    tsp_spmv_ranked_dot) from val_kind through n; args is None when the
    layout has no rows (nothing to launch)."""
    obs.step("entry.check")
    _build.check_operands(layout, x, what)
    if out is not None and (
            out.dtype != torch.float32 or out.shape != (layout.m,)
            or out.device != x.device or not out.is_contiguous()):
        raise ValueError(f"{what}: out must be a contiguous float32 "
                         f"({layout.m},) on {x.device}")
    _check_slabs(layout, what)
    if layout.vals.dtype not in _VAL_KIND:
        raise ValueError(f"{what}: unsupported vals dtype {layout.vals.dtype}")
    if layout.lcols.dtype not in _LCOL_KIND:
        raise ValueError(
            f"{what}: unsupported lcols dtype {layout.lcols.dtype}"
        )
    G = layout.num_groups
    if G and layout.grp_b0.numel() != layout.num_subtiles * G:
        raise ValueError(f"{what}: grp_b0 must hold G bases per sub-tile")
    seg_ptr, seg_chunk, nseg, split_seg, nsplit, need = _segment_args(
        layout, x, what, part=part)
    obs.step("entry.alloc")
    part = _scratch(need, x, part)
    y = torch.empty(layout.m, dtype=torch.float32,
                    device=x.device) if out is None else out
    if layout.m == 0:
        return y, None
    return y, (
        _VAL_KIND[layout.vals.dtype], _LCOL_KIND[layout.lcols.dtype],
        layout.vals.data_ptr(), layout.lcols.data_ptr(),
        layout.sub_b0.data_ptr(), layout.sub_dlo.data_ptr(),
        layout.sub_dhi.data_ptr(), layout.grp_b0.data_ptr(), G,
        layout.group_code & 0xFFFFFFFF, seg_ptr, seg_chunk, nseg, split_seg,
        nsplit, x.data_ptr(), y.data_ptr(), part.data_ptr(), layout.m,
        layout.n,
    )


@obs.entry
def spmv_ranked(layout: RankedSlabs, x: torch.Tensor,
                out: torch.Tensor | None = None,
                part: torch.Tensor | None = None) -> torch.Tensor:
    """y = A @ x with A in rank-windowed SELL layout (grouped or not).
    x: (n,) float32 -> y: (m,) float32. With `out` ((m,) float32), adds
    A @ x into it and returns it. part: the split chunks' partials
    scratch (see _segment_args), allocated when None."""
    if x.device.type == "cpu":
        y = spmv_ranked_reference(layout, x)
        return y if out is None else out.add_(y)
    y, args = ranked_walk_args(layout, x, "spmv_ranked", out, part)
    if args is None:
        return y
    obs.step("entry.launch")
    rc = _build.library().tsp_spmv_ranked(
        *args, int(out is not None), _build.stream_of(x))
    _build.check(rc, "spmv_ranked")
    spmv_ranked.launches += 1
    return y


@obs.entry
def spmv_sell(layout: SellSlabs, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with A in SELL layout (absolute columns).
    x: (n,) float32 -> y: (m,) float32."""
    if x.device.type == "cpu":
        return spmv_sell_reference(layout, x)
    obs.step("entry.check")
    _build.check_operands(layout, x, "spmv_sell")
    _check_slabs(layout, "spmv_sell")
    if layout.vals.dtype != torch.float32 or layout.cols.dtype != torch.int32:
        raise ValueError("spmv_sell: vals must be float32 and cols int32")
    seg_ptr, seg_chunk, nseg, split_seg, nsplit, need = _segment_args(
        layout, x, "spmv_sell")
    obs.step("entry.alloc")
    part = _scratch(need, x)
    y = torch.empty(layout.m, dtype=torch.float32, device=x.device)
    if layout.m == 0:
        return y
    obs.step("entry.launch")
    rc = _build.library().tsp_spmv_sell(
        layout.vals.data_ptr(), layout.cols.data_ptr(), seg_ptr, seg_chunk,
        nseg, split_seg, nsplit, x.data_ptr(), y.data_ptr(), part.data_ptr(),
        layout.m, layout.n, _build.stream_of(x),
    )
    _build.check(rc, "spmv_sell")
    spmv_sell.launches += 1
    return y


def _window_args(layout: RankedSlabs, what: str) -> tuple:
    """The window table's arguments (step_seg, step_lo, step_hi, steps,
    ring, stage size), after the checks a hand-built table can fail on
    the card."""
    T = layout.step_lo.numel()
    if any(t.dtype != torch.int32 for t in (
            layout.step_seg, layout.step_lo, layout.step_hi)) or (
            layout.step_seg.numel() != T + 1 or layout.step_hi.numel() != T):
        raise ValueError(f"{what}: the window table must be int32 step_seg "
                         "(T+1,), step_lo and step_hi (T,)")
    return (layout.step_seg.data_ptr(), layout.step_lo.data_ptr(),
            layout.step_hi.data_ptr(), T, layout.ring_blocks,
            layout.stage_subtiles)


def launch_ranked_windowed(layout: RankedSlabs, x: torch.Tensor,
                           what: str) -> torch.Tensor:
    """Checks, then csrc/windowed.cu's tsp_ranked_windowed for x (n,) or
    X (n, B) on the card: the ring walk into y (m,) or Y (m, B), one
    launch per group of at most 8 columns, then the fix-up of the split
    chunks' partial rows when the layout has any. X must be 16-byte
    aligned (the ring is filled by bulk copies)."""
    obs.step("entry.check")
    matrix = x.dim() == 2
    _build.check_operands(layout, x, what, matrix=matrix)
    _check_slabs(layout, what)
    if layout.vals.dtype not in _VAL_KIND:
        raise ValueError(f"{what}: unsupported vals dtype {layout.vals.dtype}")
    if layout.lcols.dtype not in _LCOL_KIND:
        raise ValueError(f"{what}: unsupported lcols dtype {layout.lcols.dtype}")
    if x.data_ptr() % 16:
        raise ValueError(f"{what}: x must be 16-byte aligned (a view at an "
                         "offset is not); pass a copy")
    if layout.num_subtiles % 4:
        raise ValueError(f"{what}: the layout's sub-tile count must be a "
                         "multiple of 4 (the bases are bulk-copied)")
    B = x.shape[1] if matrix else 1
    check_window(layout, B, hw.smem_per_block(x.device))
    steps = _window_args(layout, what)
    seg_ptr, seg_chunk, _, split_seg, nsplit, need = _segment_args(
        layout, x, what, B)
    obs.step("entry.alloc")
    part = _scratch(need, x)
    y = torch.empty(layout.m, *x.shape[1:], dtype=torch.float32,
                    device=x.device)
    if layout.m == 0:
        return y
    obs.step("entry.launch")
    rc = _build.library().tsp_ranked_windowed(
        _VAL_KIND[layout.vals.dtype], _LCOL_KIND[layout.lcols.dtype],
        layout.vals.data_ptr(), layout.lcols.data_ptr(),
        layout.sub_b0.data_ptr(), layout.sub_dlo.data_ptr(),
        layout.sub_dhi.data_ptr(), layout.num_subtiles, seg_ptr, seg_chunk,
        split_seg, nsplit, *steps, x.data_ptr(), y.data_ptr(),
        part.data_ptr(), layout.m,
        layout.n, B, _build.stream_of(x),
    )
    _build.check(rc, what)
    return y


def windowed_ctas(layout: RankedSlabs, batch: int = 1) -> int:
    """CTAs each launch of the windowed kernels runs on the current card
    for this layout and batch columns (its first group of at most 8): as
    many as fit at once at its shared memory, at most one per step.
    Raises like a launch."""
    ctas = _build.library().tsp_ranked_windowed_ctas(
        _VAL_KIND[layout.vals.dtype], _LCOL_KIND[layout.lcols.dtype],
        layout.step_lo.numel(), layout.ring_blocks, layout.stage_subtiles,
        batch)
    if ctas < 0:
        _build.check(-ctas, "windowed_ctas")
    return ctas


def windowed_launches(layout: RankedSlabs, batch: int = 1) -> int:
    """Device launches of one call of the windowed kernels: one per group
    of at most 8 columns, plus the split fix-up when a chunk is split."""
    return -(-batch // 8) + (layout.split_seg.shape[1] > 0)


@obs.entry
def spmv_ranked_windowed(layout: RankedSlabs, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with x staged in shared memory, a ring of ring_blocks
    blocks filled a step ahead; same layout and bits as spmv_ranked.
    Raises ValueError when the ring exceeds the card's shared memory
    (hw.smem_per_block). x: (n,) float32 -> y: (m,) float32."""
    if x.device.type == "cpu":
        return spmv_ranked_windowed_reference(layout, x)
    y = launch_ranked_windowed(layout, x, "spmv_ranked_windowed")
    spmv_ranked_windowed.launches += 1
    return y


spmv_ranked.launches = 0
spmv_ranked_windowed.launches = 0
spmv_sell.launches = 0
