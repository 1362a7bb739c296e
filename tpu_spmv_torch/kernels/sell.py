"""SELL-slab SpMV: the CUDA kernels of csrc/sell.cu and csrc/windowed.cu
and their plain PyTorch versions.

Counterpart of `tpu_spmv/kernels/pallas_sell.py`:

  spmv_ranked           replaces spmv_ranked (ungrouped and grouped
                        bodies) and its _reduce_partials epilogue;
  spmv_ranked_windowed  replaces spmv_ranked_windowed, the route for an
                        x past `resident_x_fits`: x staged in shared
                        memory, one window per layout tile;
  spmv_sell             replaces spmv_sell and its epilogue.

On a CPU tensor each runs its plain version (`*_reference`: a gather,
a reshape-sum over the 8 slots of each sub-tile, then `index_add_` of
the sub-tile sums into their chunks); on a CUDA tensor it launches the
kernel or raises. spmv_ranked and spmv_sell walk the layout's segment
table (formats/sell.segment_fields), one block per segment. `<wrapper>
.launches` counts calls that launched the kernel, once per call: a call
of spmv_ranked_windowed is two launches (the windowed pass and the
reduction of its partials), and so is a call of spmv_ranked or
spmv_sell on a layout with split chunks (the walk, then the fix-up that
adds their segments' partials).
"""

from __future__ import annotations

import torch

from tpu_spmv_torch import hw
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


def window_bytes(layout: RankedSlabs, batch: int = 1) -> int:
    """Shared memory of one block of the windowed kernels: the tile's
    window of win_span blocks of 128 rows of x, batch columns wide."""
    return layout.win_span * LANES * batch * 4


def check_window(layout: RankedSlabs, batch: int = 1,
                 budget: int | None = None) -> None:
    """Raise ValueError when the layout has no per-tile windows or its
    window, batch columns wide, exceeds `budget` bytes of shared memory
    (default: what a block may use on the current card, hw.smem_per_block).
    The counterpart of the VMEM refusal of tpu_spmv/kernels/dia.py:206."""
    if layout.win_span <= 0:
        raise ValueError(
            "layout has no per-tile windows (win_span == 0); rebuild it "
            "with RankedSlabs.from_csr before using a windowed kernel"
        )
    budget = hw.smem_per_block() if budget is None else budget
    need = window_bytes(layout, batch)
    if need > budget:
        raise ValueError(
            f"windowed x-window is {layout.win_span} blocks x {batch} "
            f"column(s) = {need} bytes, beyond the {budget}-byte "
            "shared-memory budget; rebuild at a smaller tile_k or split "
            "the columns"
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
    """Plain version of the windowed kernels, for x (n,) or X (n, B): x
    padded with win_span zero guard blocks, tile t's window the win_span
    blocks from block win_b0[t] of it (formats/sell.real_windows), and
    each slot reading its tile's window at (base(s, r) - win_b0[t]) *
    128 + lcols, never x itself, and 0 where that falls outside the
    window (the kernel's predicate; only the all-pad tail, which no chunk
    reduces, lies outside); then the sums of spmv_ranked_reference."""
    S = layout.num_subtiles
    W = layout.win_span * LANES
    blocks = (_round_up(max(layout.n, LANES), LANES) // LANES
              + layout.win_span)
    xp = torch.zeros(blocks * LANES, *x.shape[1:], dtype=torch.float32,
                     device=x.device)
    xp[: layout.n] = x
    tile_b0 = layout.win_b0.long()
    wins = xp[(tile_b0 * LANES)[:, None]
              + torch.arange(W, device=x.device)]  # (T, W[, B])
    tile = torch.arange(S, device=x.device) // (layout.tile_k // SUBLANES)
    local = ((delta_bases(layout) - tile_b0[tile][:, None]) * LANES)[
        :, :, None
    ] + layout.lcols.view(S, SUBLANES, LANES).long()
    inside = (local >= 0) & (local < W)
    xg = wins[tile[:, None, None], local.clamp(0, W - 1)]
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


def _segment_args(layout, x: torch.Tensor, what: str) -> tuple:
    """Checks of the segment table, then the walk's arguments: seg_ptr,
    seg_chunk, the segment count G, split_seg, the split-chunk count K
    and the partials scratch: one row of 128 per segment of a split
    chunk, G - num_chunks + K rows, as every other chunk has one
    segment."""
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
    part = torch.empty((G - layout.num_chunks + K) * LANES,
                       dtype=torch.float32, device=x.device)
    return (seg_ptr.data_ptr(), layout.seg_chunk.data_ptr(), G,
            layout.split_seg.data_ptr(), K, part)


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
    seg_ptr, seg_chunk, nseg, split_seg, nsplit, part = _segment_args(
        layout, x, "spmv_ranked")
    y = torch.empty(layout.m, dtype=torch.float32, device=x.device)
    if layout.m == 0:
        return y
    rc = _build.library().tsp_spmv_ranked(
        _VAL_KIND[layout.vals.dtype], _LCOL_KIND[layout.lcols.dtype],
        layout.vals.data_ptr(), layout.lcols.data_ptr(),
        layout.sub_b0.data_ptr(), layout.sub_dlo.data_ptr(),
        layout.sub_dhi.data_ptr(), layout.grp_b0.data_ptr(), G,
        layout.group_code & 0xFFFFFFFF, seg_ptr, seg_chunk, nseg, split_seg,
        nsplit, x.data_ptr(), y.data_ptr(), part.data_ptr(), layout.m,
        layout.n, _build.stream_of(x),
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
    seg_ptr, seg_chunk, nseg, split_seg, nsplit, part = _segment_args(
        layout, x, "spmv_sell")
    y = torch.empty(layout.m, dtype=torch.float32, device=x.device)
    if layout.m == 0:
        return y
    rc = _build.library().tsp_spmv_sell(
        layout.vals.data_ptr(), layout.cols.data_ptr(), seg_ptr, seg_chunk,
        nseg, split_seg, nsplit, x.data_ptr(), y.data_ptr(), part.data_ptr(),
        layout.m, layout.n, _build.stream_of(x),
    )
    _build.check(rc, "spmv_sell")
    spmv_sell.launches += 1
    return y


def launch_ranked_windowed(layout: RankedSlabs, x: torch.Tensor,
                           what: str) -> torch.Tensor:
    """Checks, then the two launches of csrc/windowed.cu's
    tsp_ranked_windowed for x (n,) or X (n, B) on the card: the
    windowed pass into per-sub-tile partials (S, 128, B), then their
    reduction into y (m,) or Y (m, B)."""
    matrix = x.dim() == 2
    _build.check_operands(layout, x, what, matrix=matrix)
    _check_slabs(layout, what)
    if layout.vals.dtype not in _VAL_KIND:
        raise ValueError(f"{what}: unsupported vals dtype {layout.vals.dtype}")
    if layout.lcols.dtype not in _LCOL_KIND:
        raise ValueError(f"{what}: unsupported lcols dtype {layout.lcols.dtype}")
    total_k = int(layout.vals.shape[0])
    T = int(layout.win_b0.numel())
    if layout.tile_k % SUBLANES or T * layout.tile_k != total_k:
        raise ValueError(
            f"{what}: win_b0 holds {T} tiles of {layout.tile_k} sublanes "
            f"for {total_k} slots"
        )
    B = x.shape[1] if matrix else 1
    check_window(layout, B, hw.smem_per_block(x.device))
    y = torch.empty(layout.m, *x.shape[1:], dtype=torch.float32,
                    device=x.device)
    if layout.m == 0:
        return y
    part = torch.empty(layout.num_subtiles * LANES * B, dtype=torch.float32,
                       device=x.device)
    rc = _build.library().tsp_ranked_windowed(
        _VAL_KIND[layout.vals.dtype], _LCOL_KIND[layout.lcols.dtype],
        layout.vals.data_ptr(), layout.lcols.data_ptr(),
        layout.sub_b0.data_ptr(), layout.sub_dlo.data_ptr(),
        layout.sub_dhi.data_ptr(), layout.win_b0.data_ptr(), T,
        layout.tile_k // SUBLANES, layout.win_span,
        layout.chunk_ptr.data_ptr(),
        x.data_ptr(), part.data_ptr(), y.data_ptr(), layout.m, layout.n, B,
        window_bytes(layout, B), _build.stream_of(x),
    )
    _build.check(rc, what)
    return y


def spmv_ranked_windowed(layout: RankedSlabs, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with x staged in shared memory, one window of win_span
    blocks per layout tile; same layout and results as spmv_ranked.
    Raises ValueError when the window exceeds the card's shared memory
    (hw.smem_per_block). x: (n,) float32 -> y: (m,) float32."""
    if x.device.type == "cpu":
        return spmv_ranked_windowed_reference(layout, x)
    y = launch_ranked_windowed(layout, x, "spmv_ranked_windowed")
    spmv_ranked_windowed.launches += 1
    return y


spmv_ranked.launches = 0
spmv_ranked_windowed.launches = 0
spmv_sell.launches = 0
