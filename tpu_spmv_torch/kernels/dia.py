"""DIA SpMV: the CUDA kernels of csrc/dia.cu and csrc/windowed.cu and
their plain PyTorch versions.

`spmv_dia(layout, x)` replaces `tpu_spmv/kernels/dia.py:spmv_dia` and
`spmv_dia_windowed(layout, x)` its `spmv_dia_windowed`, the route for an
x past `dia_x_fits`: it stages x in shared memory, a window per block of
threads. On a CPU tensor each runs its plain version; on a CUDA tensor
it launches its kernel or raises. `<wrapper>.launches` counts kernel
launches.
"""

from __future__ import annotations

import torch

from tpu_spmv_torch import hw
from tpu_spmv_torch.formats.dia import DiaSlabs
from tpu_spmv_torch.formats.sell import LANES
from tpu_spmv_torch.kernels import _build

_VAL_KIND = {torch.float32: 0, torch.bfloat16: 1}
# Rows per block of spmv_dia_windowed: at least this many, and at least
# twice the halo, so the halo is at most a third of the staged window.
_MIN_WINDOW_ROWS = 4096


def spmv_dia_reference(layout: DiaSlabs, x: torch.Tensor) -> torch.Tensor:
    """y[row] = sum_k vals[k, row] * x[row + off_k], x zero outside
    [0, n), diagonals added in ascending offset order."""
    m, n = layout.m, layout.n
    d = layout.num_diagonals
    vals = layout.vals.permute(1, 0, 2, 3).reshape(d, -1)[:, :m].float()
    lo = max(0, -min(layout.offsets))
    hi = max(0, max(layout.offsets))
    xp = torch.zeros(lo + max(n, m + hi), dtype=torch.float32, device=x.device)
    xp[lo : lo + n] = x
    y = torch.zeros(m, dtype=torch.float32, device=x.device)
    for k, off in enumerate(layout.offsets):
        y += vals[k] * xp[lo + off : lo + off + m]
    return y


def _split_offset(off: int) -> tuple:
    """off = 128 * qb + s with s in [0, 128) (the reference's split)."""
    s = off % LANES
    return (off - s) // LANES, s


def _guard_blocks(layout: DiaSlabs) -> tuple:
    """(glo, ghi): the zero guard blocks the reference pads x with below
    and above, from the block parts of the offsets."""
    qbs = [_split_offset(o)[0] for o in layout.offsets]
    return max(0, -min(qbs)), max(max(qbs) + 2, 1)


def dia_x_fits(layout: DiaSlabs, budget_frac: float = 0.5) -> bool:
    """True when the padded x, (glo + num_blocks + ghi) * 128 floats,
    fits budget_frac of the L2 of the card the layout lies on
    (hw.l2_bytes: the H100's 50 MB off the card): then spmv_dia's x
    reads stay in L2. Otherwise the CLI takes spmv_dia_windowed.

    The reference (tpu_spmv/kernels/dia.py:dia_x_fits) also charges the
    double-buffered diagonal tiles and y tile that its kernel holds in
    VMEM. No GPU kernel here holds slab tiles or partials in L2 between
    uses, so only x is charged."""
    glo, ghi = _guard_blocks(layout)
    n_pad = (glo + layout.num_blocks + ghi) * LANES
    return 4 * n_pad <= budget_frac * hw.l2_bytes(layout.vals.device)


def dia_window_rows(layout: DiaSlabs, budget: int) -> int:
    """Rows per block of spmv_dia_windowed, whose window is rows + span
    floats (span = max offset - min offset, the halo every block
    re-reads): the least multiple of 1024 that is at least
    _MIN_WINDOW_ROWS and twice the span, cut to what `budget` bytes of
    shared memory hold and to the rows there are. Raises ValueError when
    even 128 rows cannot fit."""
    span = max(layout.offsets) - min(layout.offsets)
    if (LANES + span) * 4 > budget:
        raise ValueError(
            f"windowed DIA x-window is {(LANES + span) * 4} bytes at 128 "
            f"rows (halo {span} entries), beyond the {budget}-byte "
            "shared-memory budget: the diagonal offsets span too far; use "
            "a gather kernel (ranked) for this structure"
        )
    want = max(_MIN_WINDOW_ROWS, -(-2 * span // 1024) * 1024)
    fit = (budget // 4 - span) // LANES * LANES
    rows = -(-max(layout.m, 1) // LANES) * LANES
    return min(want, fit, rows)


def spmv_dia_windowed_reference(layout: DiaSlabs,
                                x: torch.Tensor) -> torch.Tensor:
    """Plain version through the reference's per-tile windows: x padded
    with glo and ghi zero guard blocks, tile t's window the win_w =
    glo + rb + ghi blocks from block t * rb of it, and row i of the tile
    reading the window at glo * 128 + i + off for each offset, added in
    ascending offset order as spmv_dia_reference does."""
    T, D, rb, _ = layout.vals.shape
    glo, ghi = _guard_blocks(layout)
    rows = rb * LANES
    xp = torch.zeros((glo + T * rb + ghi) * LANES, dtype=torch.float32,
                     device=x.device)
    xp[glo * LANES : glo * LANES + layout.n] = x
    start = torch.arange(T, device=x.device) * rows
    wins = xp[start[:, None]
              + torch.arange((glo + rb + ghi) * LANES, device=x.device)]
    vals = layout.vals.reshape(T, D, rows).float()
    y = torch.zeros(T, rows, dtype=torch.float32, device=x.device)
    for k, off in enumerate(layout.offsets):
        lo = glo * LANES + off
        y += vals[:, k] * wins[:, lo : lo + rows]
    return y.reshape(-1)[: layout.m]


def _check_dia(layout: DiaSlabs, x: torch.Tensor, what: str) -> None:
    _build.check_operands(layout, x, what)
    if layout.vals.dtype not in _VAL_KIND:
        raise ValueError(f"{what}: unsupported vals dtype {layout.vals.dtype}")
    T, D, rb, lanes = layout.vals.shape
    if layout.offs.dtype != torch.int32 or layout.offs.numel() != D:
        raise ValueError(f"{what}: offs must be D int32 offsets")
    if T * rb * lanes < layout.m:
        raise ValueError(f"{what}: vals cover fewer rows than m")


def spmv_dia(layout: DiaSlabs, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with A in DIA layout. x: (n,) float32 -> y: (m,) float32."""
    if x.device.type == "cpu":
        return spmv_dia_reference(layout, x)
    _check_dia(layout, x, "spmv_dia")
    T, D, rb, lanes = layout.vals.shape
    y = torch.empty(layout.m, dtype=torch.float32, device=x.device)
    if layout.m == 0:
        return y
    rc = _build.library().tsp_spmv_dia(
        _VAL_KIND[layout.vals.dtype], layout.vals.data_ptr(),
        layout.offs.data_ptr(), D, rb, x.data_ptr(), y.data_ptr(),
        layout.m, layout.n, _build.stream_of(x),
    )
    _build.check(rc, "spmv_dia")
    spmv_dia.launches += 1
    return y


def spmv_dia_windowed(layout: DiaSlabs, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with x staged in shared memory, a window of
    dia_window_rows rows plus the halo per block of threads; same layout
    and results as spmv_dia. Raises ValueError when no window fits the
    card's shared memory (hw.smem_per_block)."""
    if x.device.type == "cpu":
        return spmv_dia_windowed_reference(layout, x)
    _check_dia(layout, x, "spmv_dia_windowed")
    rows = dia_window_rows(layout, hw.smem_per_block(x.device))
    span = max(layout.offsets) - min(layout.offsets)
    _, D, rb, _ = layout.vals.shape
    y = torch.empty(layout.m, dtype=torch.float32, device=x.device)
    if layout.m == 0:
        return y
    rc = _build.library().tsp_spmv_dia_windowed(
        _VAL_KIND[layout.vals.dtype], layout.vals.data_ptr(),
        layout.offs.data_ptr(), D, rb, min(layout.offsets), span, rows,
        x.data_ptr(), y.data_ptr(), layout.m, layout.n, (rows + span) * 4,
        _build.stream_of(x),
    )
    _build.check(rc, "spmv_dia_windowed")
    spmv_dia_windowed.launches += 1
    return y


spmv_dia.launches = 0
spmv_dia_windowed.launches = 0
