"""DIA SpMV: the CUDA kernels of csrc/dia.cu and csrc/windowed.cu and
their plain PyTorch versions.

`spmv_dia(layout, x)` replaces `tpu_spmv/kernels/dia.py:spmv_dia` and
`spmv_dia_windowed(layout, x)` its `spmv_dia_windowed`, which `dia_route`
picks for an x past `dia_x_fits` whose one ring fits shared memory:
persistent CTAs walk steps of S rows, a producer warp bulk-copying each
step's diagonal values into one of two stages and sliding x into a ring
of W floats in shared memory (`dia_ring` sizes both). On a CPU tensor
each runs its plain version; on a CUDA tensor it launches its kernel or
raises. `<wrapper>.launches` counts kernel launches.
"""

from __future__ import annotations

import dataclasses
import functools
import typing

import torch

from tpu_spmv_torch import hw, obs
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
# The share of the L2 that dia_x_fits holds the padded x to, and
# dia_route the band's reuse window: half, the reference's rule.
L2_BUDGET_FRAC = 0.5


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


def _padded_x_bytes(layout: DiaSlabs) -> int:
    glo, ghi = _guard_blocks(layout)
    return 4 * (glo + layout.num_blocks + ghi) * LANES


def dia_x_fits(layout: DiaSlabs,
               budget_frac: float = L2_BUDGET_FRAC) -> bool:
    """True when the padded x, (glo + num_blocks + ghi) * 128 floats,
    fits budget_frac of the L2 of the card the layout lies on
    (hw.l2_bytes: the H100's 50 MB off the card): then spmv_dia's x
    reads stay in L2. Otherwise dia_route weighs the band's L2 reuse
    window and the ring.

    The reference (tpu_spmv/kernels/dia.py:dia_x_fits) also charges the
    double-buffered diagonal tiles and y tile that its kernel holds in
    VMEM. No GPU kernel here holds slab tiles or partials in L2 between
    uses, so only x is charged."""
    return _padded_x_bytes(layout) <= budget_frac * hw.l2_bytes(
        layout.vals.device)


def l2_window_bytes(offsets, elem: int) -> int:
    """Bytes that stream through the L2 while spmv_dia holds one entry
    of x between its first and its last read: the band's span in rows
    (max(offsets) - min(offsets)) times what a row streams, its D values
    of `elem` bytes, 4 bytes of y and 4 of x."""
    return (max(offsets) - min(offsets)) * (len(offsets) * elem + 8)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


@dataclasses.dataclass(frozen=True)
class DiaRing:
    """Shared memory of one CTA of spmv_dia_windowed (csrc/windowed.cu)."""

    step_rows: int  # S: rows a step, a multiple of 128 dividing the tile
    ring: int  # W: floats of x held, >= span + 2S, a multiple of 32
    stage_bytes: int  # one stage: the D runs of a step's S values
    smem: int  # dynamic: the ring, two stages and the D offsets


def _ring_size(offsets, elem: int, rows: int) -> DiaRing:
    span = max(offsets) - min(offsets)
    d = len(offsets)
    ring = _round_up(span + DIA_STAGES * rows, 32)
    stage = _round_up(d * rows * elem, 128)
    return DiaRing(rows, ring, stage, 4 * ring + DIA_STAGES * stage + 4 * d)


def dia_smem_budget(device) -> int:
    """Dynamic shared memory a CTA of spmv_dia_windowed may take on
    `device`: the opt-in maximum (hw.smem_per_block) less the kernel's
    static shared memory (its mbarriers), as the built kernel reports it.
    Off the card no kernel runs, and the whole opt-in maximum is given."""
    budget = hw.smem_per_block(device)
    if torch.device(device).type != "cuda":
        return budget
    return budget - _static_smem()


@functools.lru_cache(maxsize=1)
def _static_smem() -> int:
    static = _build.library().tsp_dia_windowed_static_smem()
    if static < 0:
        _build.check(-static, "dia_smem_budget")
    return static


def ring_plan(offsets: tuple, rows_per_tile: int, elem: int, budget: int,
              most: int) -> DiaRing:
    """The ring of spmv_dia_windowed for ascending `offsets`, a tile of
    `rows_per_tile` rows and `elem`-byte values: the largest step S of at
    most `most` rows that is a multiple of 128, divides the tile (so a
    step's values are one contiguous run per diagonal), and whose ring of
    W = span + 2S floats (span = max offset - min offset; rounded up to 32
    floats, so every bulk copy into it stays 16-byte aligned), two stages
    of D * S values and the D offsets fit `budget` bytes of dynamic shared
    memory. Raises ValueError when not even 128 rows fit."""
    top = min(most, rows_per_tile) // LANES * LANES
    for rows in range(top, 0, -LANES):
        if rows_per_tile % rows:
            continue
        ring = _ring_size(offsets, elem, rows)
        if ring.smem <= budget:
            return ring
    need = _ring_size(offsets, elem, LANES).smem
    span = max(offsets) - min(offsets)
    raise ValueError(
        f"windowed DIA ring and stages are {need} bytes at 128 rows a step "
        f"(halo {span} entries, {len(offsets)} diagonals), beyond the "
        f"{budget}-byte shared-memory budget: the diagonal offsets span "
        "too far; use a gather kernel (ranked) for this structure"
    )


def dia_ring(layout: DiaSlabs, budget: int) -> DiaRing:
    """The ring of spmv_dia_windowed for this layout under `budget`
    bytes of dynamic shared memory (dia_smem_budget): ring_plan at the
    layout's offsets, tile and value size, and steps of at most
    DIA_STEP_ROWS rows."""
    return ring_plan(tuple(layout.offsets), layout.vals.shape[2] * LANES,
                     layout.vals.element_size(), budget, DIA_STEP_ROWS)


@dataclasses.dataclass(frozen=True)
class DiaRoute:
    """dia_route's choice of kernel for a DIA layout and what it
    compared."""

    kernel: str  # "resident" (spmv_dia) or "windowed" (spmv_dia_windowed)
    rule: str  # the test that decided it, in dia_route's order
    x_bytes: int  # the padded x
    window_bytes: int  # l2_window_bytes
    budget_bytes: int  # the share of the L2 both are held to
    ring: DiaRing | None = None  # the windowed kernel's, where routed

    @property
    def counters(self) -> dict:
        return {"dia.route_resident": int(self.kernel == "resident"),
                "dia.l2_window_bytes": self.window_bytes,
                "dia.l2_budget_bytes": self.budget_bytes}


def dia_route(layout: DiaSlabs) -> DiaRoute:
    """The kernel for this layout on the card it lies on, from the first
    of these tests that holds (budget: L2_BUDGET_FRAC of the L2, as
    dia_x_fits):

    1. "x fits": the padded x within the budget -> resident;
    2. "one ring": the ring fits shared memory (dia_ring does not
       raise), so the windowed kernel stages x once -> windowed;
    3. "reuse window": l2_window_bytes within the budget, so x survives
       in the L2 between its first and last read -> resident;
    4. "past the window": resident too, its x re-read from device memory
       once for each far group of diagonals. A ring cut into one segment
       for each such group, which stages x once a segment and steps at a
       lower rate, lost to it on an H100: resident was 1.83x faster with
       the window at 232% of the budget (27-point, 512 x 512 x 64) and
       1.72x at 929% (1024 x 1024 x 16).

    Sets the counters (obs) dia.route_resident, dia.l2_window_bytes and
    dia.l2_budget_bytes once, here, not per call."""
    dev = layout.vals.device
    budget = int(L2_BUDGET_FRAC * hw.l2_bytes(dev))
    x_bytes = _padded_x_bytes(layout)
    window = l2_window_bytes(layout.offsets, layout.vals.element_size())

    def route(kernel, rule, ring=None):
        chosen = DiaRoute(kernel, rule, x_bytes, window, budget, ring)
        obs.set_counters(chosen.counters)
        return chosen

    if x_bytes <= budget:
        return route("resident", "x fits")
    try:
        ring = dia_ring(layout, dia_smem_budget(dev))
    except ValueError:
        pass
    else:
        return route("windowed", "one ring", ring)
    if window <= budget:
        return route("resident", "reuse window")
    return route("resident", "past the window")


def x_staged_floats(offsets, ring: DiaRing, m: int, n: int,
                    ctas: int) -> int:
    """Entries of x (inside [0, n)) that one call of spmv_dia_windowed
    copies into shared memory over all its CTAs: CTA b walks steps [i0,
    i1) (an even share of the ceil(m / S) steps) and stages x over
    [i0 S + lo, i1 S + hi), lo and hi the lowest and highest offsets."""
    S = ring.step_rows
    steps = -(-m // S)
    total = 0
    for b in range(ctas):
        i0, i1 = b * steps // ctas, (b + 1) * steps // ctas
        if i1 > i0:
            lo = max(i0 * S + offsets[0], 0)
            hi = min(i1 * S + offsets[-1], n)
            total += max(hi - lo, 0)
    return total


def spmv_dia_windowed_reference(layout: DiaSlabs,
                                x: torch.Tensor) -> torch.Tensor:
    """Plain version through a window of x a tile: the tile's rows + the
    band's span entries of x from the tile's first row plus the lowest
    offset (zero outside [0, n)), row i of the tile reading it at i + off
    - lowest; the diagonals added in ascending offset order, as
    spmv_dia_reference adds them."""
    T, D, rb, _ = layout.vals.shape
    rows = rb * LANES
    offs = layout.offsets
    below, above = max(0, -min(offs)), max(0, max(offs))
    xp = torch.zeros(below + T * rows + above, dtype=torch.float32,
                     device=x.device)
    xp[below : below + layout.n] = x
    start = torch.arange(T, device=x.device) * rows + below + offs[0]
    wins = xp[start[:, None]
              + torch.arange(rows + offs[-1] - offs[0], device=x.device)]
    vals = layout.vals.reshape(T, D, rows).float()
    y = torch.zeros(T, rows, dtype=torch.float32, device=x.device)
    for k, off in enumerate(offs):
        at = off - offs[0]
        y += vals[:, k] * wins[:, at : at + rows]
    return y.reshape(-1)[: layout.m]


def _check_dia(layout: DiaSlabs, x: torch.Tensor, what: str) -> None:
    obs.step("entry.check")
    _build.check_operands(layout, x, what)
    if layout.vals.dtype not in _VAL_KIND:
        raise ValueError(f"{what}: unsupported vals dtype {layout.vals.dtype}")
    T, D, rb, lanes = layout.vals.shape
    if layout.offs.dtype != torch.int32 or layout.offs.numel() != D:
        raise ValueError(f"{what}: offs must be D int32 offsets")
    if T * rb * lanes < layout.m:
        raise ValueError(f"{what}: vals cover fewer rows than m")


@obs.entry
def spmv_dia(layout: DiaSlabs, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with A in DIA layout. x: (n,) float32 -> y: (m,) float32."""
    if x.device.type == "cpu":
        return spmv_dia_reference(layout, x)
    _check_dia(layout, x, "spmv_dia")
    T, D, rb, lanes = layout.vals.shape
    obs.step("entry.alloc")
    y = torch.empty(layout.m, dtype=torch.float32, device=x.device)
    if layout.m == 0:
        return y
    obs.step("entry.launch")
    rc = _build.library().tsp_spmv_dia(
        _VAL_KIND[layout.vals.dtype], layout.vals.data_ptr(),
        layout.offs.data_ptr(), D, rb, x.data_ptr(), y.data_ptr(),
        layout.m, layout.n, _build.stream_of(x),
    )
    _build.check(rc, "spmv_dia")
    spmv_dia.launches += 1
    return y


def _ring_args(shape, dtype, ring: DiaRing) -> tuple:
    """The C entries' sizes for vals of `shape` and `dtype`: val_kind, D,
    rb, S, W and stage_bytes."""
    _, D, rb, _ = shape
    return (_VAL_KIND[dtype], D, rb, ring.step_rows, ring.ring,
            ring.stage_bytes)


def _ctas(sizes: tuple, m: int, smem: int, device) -> int:
    with torch.cuda.device(device):
        ctas = _build.library().tsp_dia_windowed_ctas(*sizes, max(m, 1),
                                                      smem)
    if ctas < 0:
        _build.check(-ctas, "dia_windowed_ctas")
    return ctas


def dia_windowed_ctas(layout: DiaSlabs, ring: DiaRing) -> int:
    """CTAs a launch of spmv_dia_windowed runs on the current card for
    this layout and ring: as many as fit at once at its shared memory, at
    most one per step. Raises like a launch."""
    return _ctas(_ring_args(layout.vals.shape, layout.vals.dtype, ring),
                 layout.m, ring.smem, layout.vals.device)


class _Launch(typing.NamedTuple):
    ring: DiaRing
    sizes: tuple  # _ring_args
    staged: int  # x_staged_floats: a call's counter dia.x_staged_floats


@functools.lru_cache(maxsize=64)
@obs.span("build.dia_ring")
def _launch_plan(offsets: tuple, shape: tuple, dtype, m: int, n: int,
                 budget: int, most: int, device: torch.device) -> _Launch:
    """The ring (ring_plan), the C entry's sizes and the entries of x a
    call stages, planned once per layout shape, budget, step limit and
    card, in the phase span build.dia_ring."""
    if list(offsets) != sorted(offsets):
        raise ValueError("spmv_dia_windowed: offsets must be ascending")
    elem = torch.empty((), dtype=dtype).element_size()
    ring = ring_plan(offsets, shape[2] * LANES, elem, budget, most)
    sizes = _ring_args(shape, dtype, ring)
    ctas = _ctas(sizes, m, ring.smem, device)
    return _Launch(ring, sizes, x_staged_floats(offsets, ring, m, n, ctas))


@obs.entry
def spmv_dia_windowed(layout: DiaSlabs, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x through a ring of x in shared memory filled a step ahead
    (dia_ring; planned once per layout shape and card); same layout and
    bits as spmv_dia. Raises ValueError when vals is not 16-byte aligned
    or the ring does not fit the card's shared memory (dia_smem_budget).
    Each call sets the counter (obs) dia.x_staged_floats
    (x_staged_floats)."""
    if x.device.type == "cpu":
        return spmv_dia_windowed_reference(layout, x)
    _check_dia(layout, x, "spmv_dia_windowed")
    if layout.vals.data_ptr() % 16:
        raise ValueError("spmv_dia_windowed: vals must be 16-byte aligned "
                         "(a step's values are bulk-copied); pass a copy")
    plan = _launch_plan(tuple(layout.offsets), tuple(layout.vals.shape),
                        layout.vals.dtype, layout.m, layout.n,
                        dia_smem_budget(x.device), DIA_STEP_ROWS, x.device)
    kind, *sizes = plan.sizes
    obs.step("entry.alloc")
    y = torch.empty(layout.m, dtype=torch.float32, device=x.device)
    if layout.m == 0:
        return y
    obs.step("entry.launch")
    rc = _build.library().tsp_spmv_dia_windowed(
        kind, layout.vals.data_ptr(), layout.offs.data_ptr(), *sizes,
        x.data_ptr(), y.data_ptr(), layout.m, layout.n, plan.ring.smem,
        _build.stream_of(x),
    )
    _build.check(rc, "spmv_dia_windowed")
    spmv_dia_windowed.launches += 1
    obs.set_counters({"dia.x_staged_floats": plan.staged})
    return y


spmv_dia.launches = 0
spmv_dia_windowed.launches = 0
