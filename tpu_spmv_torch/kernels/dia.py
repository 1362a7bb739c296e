"""DIA SpMV: the CUDA kernels of csrc/dia.cu and csrc/windowed.cu and
their plain PyTorch versions.

`spmv_dia(layout, x)` replaces `tpu_spmv/kernels/dia.py:spmv_dia` and
`spmv_dia_windowed(layout, x)` its `spmv_dia_windowed`, the route for an
x past `dia_x_fits`: persistent CTAs walk steps of S rows, a producer
warp bulk-copying each step's diagonal values into one of two stages and
sliding x into a ring of W floats in shared memory (`dia_ring` sizes
both). On a CPU tensor each runs its plain version; on a CUDA tensor it
launches its kernel or raises. `<wrapper>.launches` counts kernel
launches.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_spmv_torch import hw
from tpu_spmv_torch.formats.dia import DiaSlabs
from tpu_spmv_torch.formats.sell import LANES
from tpu_spmv_torch.kernels import _build

_VAL_KIND = {torch.float32: 0, torch.bfloat16: 1}
# Rows a step of spmv_dia_windowed's ring (csrc/windowed.cu), the most
# dia_ring takes: a smaller step where this one does not fit shared
# memory or divide the layout's tile. On an H100, 512, 1024 and 2048 rows
# were timed (tpu_spmv_torch/bench/dia_times.py; PERF.md).
DIA_STEP_ROWS = 1024
# Stages of the DIA ring (csrc/windowed.cu's kDiaStages): the producer
# runs at most one step ahead of the consumers, so the ring holds the
# windows of two steps. A third stage was 4% slower on lap2d_4096 (H100,
# PERF.md). The launcher refuses a shared-memory size that does not hold
# its own count of stages, so the two cannot drift apart unnoticed.
DIA_STAGES = 2


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


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


@dataclasses.dataclass(frozen=True)
class DiaRing:
    """Shared memory of one CTA of spmv_dia_windowed (csrc/windowed.cu)."""

    step_rows: int  # S: rows a step, a multiple of 128 dividing the tile
    ring: int  # W: floats of x held, >= span + 2S, a multiple of 32
    stage_bytes: int  # one stage: the D runs of a step's S values
    smem: int  # dynamic: the ring, two stages and the D offsets


def _ring_at(layout: DiaSlabs, rows: int) -> DiaRing:
    span = max(layout.offsets) - min(layout.offsets)
    d = layout.num_diagonals
    ring = _round_up(span + DIA_STAGES * rows, 32)
    stage = _round_up(d * rows * layout.vals.element_size(), 128)
    return DiaRing(rows, ring, stage, 4 * ring + DIA_STAGES * stage + 4 * d)


def dia_smem_budget(device) -> int:
    """Dynamic shared memory a CTA of spmv_dia_windowed may take on
    `device`: the opt-in maximum (hw.smem_per_block) less the kernel's
    static shared memory (its mbarriers), as the built kernel reports it.
    Off the card no kernel runs, and the whole opt-in maximum is given."""
    budget = hw.smem_per_block(device)
    if torch.device(device).type != "cuda":
        return budget
    static = _build.library().tsp_dia_windowed_static_smem()
    if static < 0:
        _build.check(-static, "dia_smem_budget")
    return budget - static


def dia_ring(layout: DiaSlabs, budget: int) -> DiaRing:
    """The ring of spmv_dia_windowed: the largest step S of at most
    DIA_STEP_ROWS rows that is a multiple of 128, divides the layout's
    tile (rb * 128 rows, so a step's values are one contiguous run per
    diagonal) and whose ring of W = span + 2S floats (span = max offset -
    min offset; rounded up to 32 floats, so every bulk copy into it stays
    16-byte aligned), two stages of D * S values and the D offsets fit
    `budget` bytes of dynamic shared memory (dia_smem_budget). Raises
    ValueError when not even 128 rows fit."""
    rows_per_tile = layout.vals.shape[2] * LANES
    top = min(DIA_STEP_ROWS, rows_per_tile) // LANES * LANES
    for rows in range(top, 0, -LANES):
        if rows_per_tile % rows:
            continue
        ring = _ring_at(layout, rows)
        if ring.smem <= budget:
            return ring
    need = _ring_at(layout, LANES).smem
    span = max(layout.offsets) - min(layout.offsets)
    raise ValueError(
        f"windowed DIA ring and stages are {need} bytes at 128 rows a step "
        f"(halo {span} entries, {layout.num_diagonals} diagonals), beyond "
        f"the {budget}-byte shared-memory budget: the diagonal offsets span "
        "too far; use a gather kernel (ranked) for this structure"
    )


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


def _ring_args(layout: DiaSlabs, ring: DiaRing) -> tuple:
    _, D, rb, _ = layout.vals.shape
    return (_VAL_KIND[layout.vals.dtype], D, rb, ring.step_rows, ring.ring,
            ring.stage_bytes)


def dia_windowed_ctas(layout: DiaSlabs, ring: DiaRing) -> int:
    """CTAs a launch of spmv_dia_windowed runs on the current card for
    this layout and ring: as many as fit at once at its shared memory, at
    most one per step. Raises like a launch."""
    ctas = _build.library().tsp_dia_windowed_ctas(
        *_ring_args(layout, ring), max(layout.m, 1), ring.smem)
    if ctas < 0:
        _build.check(-ctas, "dia_windowed_ctas")
    return ctas


def spmv_dia_windowed(layout: DiaSlabs, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x through a ring of x in shared memory filled a step ahead
    (dia_ring); same layout and bits as spmv_dia. Raises ValueError when
    vals is not 16-byte aligned or no ring fits the card's shared memory
    (dia_smem_budget)."""
    if x.device.type == "cpu":
        return spmv_dia_windowed_reference(layout, x)
    _check_dia(layout, x, "spmv_dia_windowed")
    if list(layout.offsets) != sorted(layout.offsets):
        raise ValueError("spmv_dia_windowed: offsets must be ascending")
    if layout.vals.data_ptr() % 16:
        raise ValueError("spmv_dia_windowed: vals must be 16-byte aligned "
                         "(a step's values are bulk-copied); pass a copy")
    ring = dia_ring(layout, dia_smem_budget(x.device))
    y = torch.empty(layout.m, dtype=torch.float32, device=x.device)
    if layout.m == 0:
        return y
    kind, *sizes = _ring_args(layout, ring)
    rc = _build.library().tsp_spmv_dia_windowed(
        kind, layout.vals.data_ptr(), layout.offs.data_ptr(), *sizes,
        x.data_ptr(), y.data_ptr(), layout.m, layout.n, ring.smem,
        _build.stream_of(x),
    )
    _build.check(rc, "spmv_dia_windowed")
    spmv_dia_windowed.launches += 1
    return y


spmv_dia.launches = 0
spmv_dia_windowed.launches = 0
