"""The ring of spmv_dia_windowed (csrc/windowed.cu's dia_ring_kernel) on
the CPU: its host sizing (kernels/dia.dia_ring) and a step-by-step model
of the walk in plain torch.

The sizing: the step S, a multiple of 128 that divides the layout's
tile, at most DIA_STEP_ROWS, and the largest whose ring and two stages
fit the budget; the ring holds W >= span + 2S floats, a multiple of 32,
so every bulk copy into it is 16-byte aligned; the refusal names the
bytes of 128 rows a step. HPCG's 256^3 operator is refused from its
offsets alone.

The model walks each CTA's contiguous steps as the kernel does: the
producer stages step t + 1 (its D value runs, and the S entries of x
past step t's window, the whole window of S + span at a CTA's first
step) before the consumers read step t, the most the kernel's barriers
let it run ahead; x goes into ring slot (g + xa - ubase) mod W, its
16-byte aligned part in one bulk copy or two where it wraps the ring
(each checked aligned), the unaligned ends and the entries outside [0,
n) by "lanes" (0 outside). The ring starts as NaN, so a read of a slot
never written, or overwritten too early, shows. Its result is held to
spmv_dia_reference and to the JAX package's spmv_dia_windowed (Pallas,
interpret mode) on the same layout: RelL2 <= 1e-6 and Number Wrong 0
against each (the model adds in float32 without fused multiply-adds, the
kernel with them); bf16 layouts against CSRMatrix.rounded; on a 27-point
stencil bit for bit against spmv_dia_reference. Cases:
offsets with no multiple of 4, positive and negative offsets only, n not
a multiple of 128 (a partial last step), steps that end at a tile's end
(S = the tile) and inside it, x at each 4-byte offset from a 16-byte
boundary, and CTA counts from one to more than the steps.
"""

import dataclasses
import functools
import itertools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_spmv.formats import csr as jcsr
from tpu_spmv.formats import dia as jdia
from tpu_spmv.kernels.dia import spmv_dia_windowed as jax_dia_windowed

from tpu_spmv_torch import hw
from tpu_spmv_torch.bench.harness import validate
from tpu_spmv_torch.bench.matrices import laplacian_2d
from tpu_spmv_torch.bench.solve_times import hpcg27
from tpu_spmv_torch.formats.convert import from_reference
from tpu_spmv_torch.formats.csr import CSRMatrix
from tpu_spmv_torch.formats.dia import DiaSlabs
from tpu_spmv_torch.formats.sell import LANES
from tpu_spmv_torch.kernels import dia as kdia

from test_torch_dia_route import _hpcg, _ring_at
from test_torch_gpu import DIAGONALS, diagonal_matrix


def _ring_fits(lay, rows, budget):
    return _ring_at(lay, rows).smem <= budget


SIZINGS = {
    "lap2d_f32": (lambda: DiaSlabs.from_csr(laplacian_2d(64)), None),
    "lap2d_bf16": (lambda: DiaSlabs.from_csr(laplacian_2d(64),
                                             val_dtype=torch.bfloat16), None),
    "tile_3072_step_2048": (
        lambda: DiaSlabs.from_csr(laplacian_2d(64), rows_per_tile=3072),
        2048),
    "odd_offsets_tile_1024": (
        lambda: DiaSlabs.from_csr(diagonal_matrix(*DIAGONALS["odd_offsets"]),
                                  rows_per_tile=1024), None),
    "wide_halo_40_diagonals": (
        lambda: DiaSlabs.from_csr(diagonal_matrix(
            20000, tuple(range(-19, 20)) + (6000,))), None),
}


@pytest.mark.parametrize("budget", [hw.H100_SMEM_PER_BLOCK, 70000])
@pytest.mark.parametrize("case", sorted(SIZINGS))
def test_dia_ring_sizing(case, budget, monkeypatch):
    make, most = SIZINGS[case]
    if most:
        monkeypatch.setattr(kdia, "DIA_STEP_ROWS", most)
    lay = make()
    tile = lay.vals.shape[2] * LANES
    span = max(lay.offsets) - min(lay.offsets)
    ring = kdia.dia_ring(lay, budget)
    S, W = ring.step_rows, ring.ring
    assert S % LANES == 0 and tile % S == 0 and S <= kdia.DIA_STEP_ROWS
    assert kdia.DIA_STAGES == 2
    assert W >= span + 2 * S and W % 32 == 0
    stage = -(-lay.num_diagonals * S * lay.vals.element_size() // 128) * 128
    assert ring.stage_bytes == stage
    assert ring.smem == 4 * W + 2 * stage + 4 * lay.num_diagonals
    assert ring.smem <= budget
    assert ring == _ring_at(lay, S)
    # The largest step that divides the tile and fits.
    assert not any(
        tile % rows == 0 and _ring_fits(lay, rows, budget)
        for rows in range(S + LANES, min(kdia.DIA_STEP_ROWS, tile) + 1,
                          LANES))


def test_dia_smem_budget_off_the_card_is_the_opt_in_maximum():
    """Off the card the plain version runs and no kernel reports its
    static shared memory: the sizing takes the H100's opt-in maximum."""
    assert kdia.dia_smem_budget("cpu") == hw.H100_SMEM_PER_BLOCK


def test_dia_ring_takes_the_tile_when_it_is_the_step():
    lay = DiaSlabs.from_csr(laplacian_2d(64), rows_per_tile=1024)
    assert kdia.dia_ring(lay, hw.H100_SMEM_PER_BLOCK).step_rows == 1024


@pytest.mark.parametrize("case", sorted(SIZINGS))
def test_dia_ring_refuses_when_128_rows_do_not_fit(case):
    """The refusal comes only when the ring does not fit at 128 rows; it
    names the bytes it needs there."""
    lay = SIZINGS[case][0]()
    need = _ring_at(lay, LANES).smem
    assert kdia.dia_ring(lay, need).step_rows == LANES
    with pytest.raises(ValueError, match=f"{need} bytes at 128 rows a step"):
        kdia.dia_ring(lay, need - 1)


def ring_walk(lay, x, ring, ctas, xa=0):
    """y by the kernel's walk (see the module docstring), and for each
    CTA (its steps, the entries it wrote into its ring, the entries of x
    among them)."""
    S, W = ring.step_rows, ring.ring
    offs = list(lay.offsets)
    _, D, rb, _ = lay.vals.shape
    low, span = offs[0], offs[-1] - offs[0]
    tile = rb * LANES
    m, n = lay.m, lay.n
    vals = lay.vals.float()
    steps = -(-m // S)
    y = torch.full((m,), float("nan"))
    written = []
    for b in range(ctas):
        i0, i1 = b * steps // ctas, (b + 1) * steps // ctas
        if i1 <= i0:
            continue
        ubase = (i0 * S + low + xa) // 4 * 4
        e = i0 * S + low + xa - ubase
        # Each diagonal's slot past pos0.
        dk = [offs[k] - low + e for k in range(D)]
        buf = torch.full((W,), float("nan"))
        stage = {}
        count = [0, 0]

        def produce(t):
            r0 = (i0 + t) * S
            tt, blk = divmod(r0, tile)
            stage[t % 2] = vals[tt, :, blk // LANES:(blk + S) // LANES].reshape(
                D, S)
            lo = r0 + low + (span if t else 0)
            hi = r0 + S + low + span
            c0, c1 = max(lo, 0), min(hi, n)
            ga = gb = hi
            if c1 > c0:
                ua, ub = -(-(c0 + xa) // 4) * 4, (c1 + xa) // 4 * 4
                if ub > ua:
                    ga, gb = ua - xa, ub - xa
            if gb > ga:
                p = (ga + xa - ubase) % W
                first = min(gb - ga, W - p)
                for dst, src, cnt in ((p, ga, first),
                                      (0, ga + first, gb - ga - first)):
                    if cnt:
                        assert dst % 4 == 0 and (src + xa) % 4 == 0
                        assert cnt % 4 == 0
                        buf[dst:dst + cnt] = x[src:src + cnt]
            for g in [*range(lo, ga), *range(gb, hi)]:
                buf[(g + xa - ubase) % W] = float(x[g]) if 0 <= g < n else 0.0
            count[0] += hi - lo
            count[1] += max(0, min(hi, n) - max(lo, 0))

        def consume(t):
            r0 = (i0 + t) * S
            pos0 = t * S % W
            rows = min(S, m - r0)
            i = torch.arange(rows)
            acc = torch.zeros(rows)
            for k in range(D):
                q = pos0 + i + dk[k]
                assert int(q.max()) < 2 * W  # one subtraction wraps it
                q = torch.where(q >= W, q - W, q)
                acc = acc + stage[t % 2][k, :rows] * buf[q]
            y[r0:r0 + rows] = acc

        produce(0)
        for t in range(i1 - i0):
            if t + 1 < i1 - i0:
                produce(t + 1)  # the producer runs one step ahead
            consume(t)
        written.append((i1 - i0, count[0], count[1]))
    return y, written


def _pair(mat, rows_per_tile, bf16):
    """The JAX package's layout and the port's copy of it."""
    ref = jdia.DiaSlabs.from_csr(
        jcsr.CSRMatrix(mat.indptr, mat.indices, mat.data, mat.shape),
        rows_per_tile=rows_per_tile,
        val_dtype=jnp.bfloat16 if bf16 else None)
    return ref, from_reference(ref)


def _close(y, other):
    wrong, rel = validate(np.asarray(y), np.asarray(other))
    assert wrong == 0 and rel <= 1e-6, (wrong, rel)


MODEL_CASES = {
    **{name: (lambda n=n, o=o: diagonal_matrix(n, o), 1024)
       for name, (n, o) in DIAGONALS.items()},
    "lap2d_40_tile_2048": (lambda: laplacian_2d(40), 2048),
}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows", [512, 1024])
@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_ring_model_matches_the_plain_version_and_pallas(case, rows, bf16,
                                                         monkeypatch):
    """Steps of 512 rows end inside a 1024-row tile and at its end; of
    1024 rows, at the tile's end (or inside lap2d_40's 2048-row tile).
    Three CTAs, each walking several steps."""
    make, rows_per_tile = MODEL_CASES[case]
    mat = make()
    monkeypatch.setattr(kdia, "DIA_STEP_ROWS", rows)
    ref, lay = _pair(mat, rows_per_tile, bf16)
    ring = kdia.dia_ring(lay, hw.H100_SMEM_PER_BLOCK)
    assert ring.step_rows == rows
    x = np.random.default_rng(2).standard_normal(mat.n).astype(np.float32)
    y, written = ring_walk(lay, torch.from_numpy(x), ring, ctas=3)
    span = max(lay.offsets) - min(lay.offsets)
    # x is read once per CTA run, plus one halo.
    assert all(cnt == nt * rows + span for nt, cnt, _ in written)
    assert sum(nt for nt, _, _ in written) == -(-mat.m // rows)
    _close(y, kdia.spmv_dia_reference(lay, torch.from_numpy(x)))
    _close(y, jax_dia_windowed(ref, jnp.asarray(x), interpret=True))
    oracle = mat.rounded() if bf16 else mat
    _close(y, oracle.matvec(x))


@pytest.mark.parametrize("xa", [0, 1, 2, 3])
@pytest.mark.parametrize("ctas", [1, 2, 5, 100])
def test_ring_model_at_any_alignment_and_grid(xa, ctas, monkeypatch):
    """x at each 4-byte offset from a 16-byte boundary (the kernel reads
    it from the pointer), and grids of one CTA (the ring wraps many
    times) up to more CTAs than steps (some walk none)."""
    n, offs = DIAGONALS["odd_offsets"]
    mat = diagonal_matrix(n, offs)
    monkeypatch.setattr(kdia, "DIA_STEP_ROWS", 256)
    lay = DiaSlabs.from_csr(mat, rows_per_tile=1024)
    ring = kdia.dia_ring(lay, hw.H100_SMEM_PER_BLOCK)
    x = torch.from_numpy(
        np.random.default_rng(3).standard_normal(n).astype(np.float32))
    y, _ = ring_walk(lay, x, ring, ctas=ctas, xa=xa)
    _close(y, kdia.spmv_dia_reference(lay, x))


def test_ring_model_holds_a_tight_ring():
    """The ring at span + 2S floats, rounded up to 4 (the least the
    kernel takes), serves every read; 4 fewer would not."""
    n, offs = DIAGONALS["odd_offsets"]
    mat = diagonal_matrix(n, offs)
    lay = DiaSlabs.from_csr(mat, rows_per_tile=1024)
    span = max(offs) - min(offs)
    S = 256
    x = torch.from_numpy(
        np.random.default_rng(3).standard_normal(n).astype(np.float32))
    tight = kdia.DiaRing(S, -(-(span + 2 * S) // 4) * 4, 0, 0)
    y, _ = ring_walk(lay, x, tight, ctas=1)
    _close(y, kdia.spmv_dia_reference(lay, x))
    short = dataclasses.replace(tight, ring=tight.ring - 4)
    y, _ = ring_walk(lay, x, short, ctas=1)
    assert not torch.isfinite(y).all() or not torch.allclose(
        y, kdia.spmv_dia_reference(lay, x))


def _stencil27(nx, ny, nz, seed=5):
    """A 27-point stencil on an nx x ny x nz grid (x fastest), standard
    normal values, so that every diagonal's share of a row shows."""
    idx = np.arange(nx * ny * nz).reshape(nz, ny, nx)
    rows, cols = [], []
    for dz, dy, dx in itertools.product((-1, 0, 1), repeat=3):
        src = idx[max(0, -dz):nz - max(0, dz), max(0, -dy):ny - max(0, dy),
                  max(0, -dx):nx - max(0, dx)]
        rows.append(src.reshape(-1))
        cols.append((src + dz * nx * ny + dy * nx + dx).reshape(-1))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = np.random.default_rng(seed).standard_normal(rows.size)
    n = nx * ny * nz
    return CSRMatrix.from_coo(rows, cols, vals.astype(np.float32), (n, n))


def _hpcg_offsets(nx, ny=None):
    ny = ny or nx
    return tuple(sorted(dz * nx * ny + dy * nx + dx for dz, dy, dx
                        in itertools.product((-1, 0, 1), repeat=3)))


@pytest.mark.parametrize("n,nz", [(4, 2), (5, 3), (6, 6)])
def test_hpcg27_on_a_flat_grid(n, nz):
    """bench.solve_times.hpcg27(n, nz): HPCG's operator on an n x n x nz
    grid ((3n - 2)^2 (3nz - 2) nonzeros, 26 on the diagonal, -1 off it),
    the pattern of the 27-point stencil; chip_smoke runs it at 256 x 256
    x 16, which has the 256^3 grid's offsets."""
    mat = hpcg27(n, nz)
    pattern = _stencil27(n, n, nz)
    assert mat.shape == (n * n * nz,) * 2
    assert mat.nnz == (3 * n - 2) ** 2 * (3 * nz - 2)
    assert np.array_equal(mat.indptr, pattern.indptr)
    assert np.array_equal(mat.indices, pattern.indices)
    rows = np.repeat(np.arange(mat.m), np.diff(mat.indptr))
    assert np.array_equal(mat.data,
                          np.where(mat.indices == rows, 26.0, -1.0))
    assert DiaSlabs.from_csr(mat, max_fill=27).offsets == _hpcg_offsets(n)


def _refused_bytes(offs, tile, elem, budget):
    """The bytes ring_plan's refusal names for steps of 128 rows."""
    with pytest.raises(ValueError, match="bytes at 128 rows a step") as err:
        kdia.ring_plan(offs, tile, elem, budget, 1024)
    return int(re.search(r"are (\d+) bytes", str(err.value)).group(1))


def test_hpcg_256_has_no_ring_and_routes_by_its_reuse_window():
    """NVIDIA's HPCG grid, 256^3 a GPU: one ring over every offset needs
    ~555 KB at 128 rows, past the H100's shared memory, so spmv_dia runs
    it: its band's reuse window fits half the L2."""
    offs = _hpcg_offsets(256)
    assert max(offs) - min(offs) == 131_586
    need = _refused_bytes(offs, 32768, 4, hw.H100_SMEM_PER_BLOCK)
    assert need == kdia._ring_size(offs, 4, LANES).smem >= 555_000
    with pytest.raises(ValueError, match=f"{need} bytes"):
        kdia.dia_ring(_hpcg(256), hw.H100_SMEM_PER_BLOCK)
    route = kdia.dia_route(_hpcg(256))
    assert (route.kernel, route.rule) == ("resident", "reuse window")


@pytest.mark.parametrize("offs,tile,elem,rows", [
    ((-4096, -1, 0, 1, 4096), 32768, 4, 1024),  # lap2d_4096 f32
    ((-4096, -1, 0, 1, 4096), 65536, 2, 1024),  # lap2d_4096 bf16
    (_hpcg_offsets(104), 32768, 4, 512),  # HPCG's 104^3 grid
    (_hpcg_offsets(160), 32768, 4, None),  # the smallest with no ring
])
def test_the_fewest_segments_that_fit(offs, tile, elem, rows):
    """The one ring's step on the card's grids, or its refusal: HPCG's
    160^3 grid, the smallest cube whose ring does not fit at 128 rows."""
    budget = hw.H100_SMEM_PER_BLOCK
    if rows is None:
        assert _refused_bytes(offs, tile, elem, budget) > budget
        return
    ring = kdia.ring_plan(offs, tile, elem, budget, 1024)
    assert ring == kdia._ring_size(offs, elem, rows)


def test_the_ring_is_planned_once_in_its_phase_span(monkeypatch):
    """spmv_dia_windowed's launch plan (the ring, the C entry's sizes and
    the call's staged count) is made once per layout shape, budget and card,
    in the phase span build.dia_ring; the CTA count, the one card query,
    is stubbed here."""
    from tpu_spmv_torch import obs

    lay = DiaSlabs.from_csr(laplacian_2d(64))
    asked = []
    monkeypatch.setattr(kdia, "_ctas",
                        lambda sizes, m, smem, device: asked.append(m) or 5)
    args = (tuple(lay.offsets), tuple(lay.vals.shape), lay.vals.dtype,
            lay.m, lay.n, 100_000, kdia.DIA_STEP_ROWS, torch.device("cuda"))
    kdia._launch_plan.cache_clear()
    obs.reset()
    try:
        first = kdia._launch_plan(*args)
        assert kdia._launch_plan(*args) is first and asked == [lay.m]
        assert [s.name for s in obs.spans()] == ["build.dia_ring"]
        ring = kdia.dia_ring(lay, 100_000)
        assert first.ring == ring
        assert first.staged == kdia.x_staged_floats(
            lay.offsets, ring, lay.m, lay.n, 5)
    finally:
        kdia._launch_plan.cache_clear()
        obs.reset()


# A 32 x 32 x 4 grid: planes 1,024 rows apart, so the ring spans 2,114
# entries. Budgets that once fit three rings at 128 rows, one a plane,
# and not one ring.
SPLIT_BUDGETS = {"f32": (False, 35_000), "bf16": (True, 20_000)}


@functools.lru_cache(maxsize=None)
def _stencil_case(vdt):
    """The 32 x 32 x 4 stencil, the JAX package's layout of it and the
    port's copy, x, and the JAX package's spmv_dia_windowed of x (Pallas
    in interpret mode, ~1.6 s, so made once a value type)."""
    mat = _stencil27(32, 32, 4)
    bf16 = SPLIT_BUDGETS[vdt][0]
    ref, lay = _pair(mat, None, bf16)
    x = np.random.default_rng(6).standard_normal(mat.n).astype(np.float32)
    y_jax = np.asarray(jax_dia_windowed(ref, jnp.asarray(x), interpret=True))
    return mat, lay, torch.from_numpy(x), y_jax


@pytest.mark.parametrize("xa", [0, 3])
@pytest.mark.parametrize("ctas", [1, 3, 7])
@pytest.mark.parametrize("vdt", sorted(SPLIT_BUDGETS))
def test_stencil_walk_is_the_plain_versions_bits(vdt, ctas, xa):
    """The ring under the card's budget on a 27-point stencil: f32 steps
    of 512 rows, bf16 of 1,024 (4 steps, so 7 CTAs leave some with none)."""
    bf16, _ = SPLIT_BUDGETS[vdt]
    mat, lay, x, y_jax = _stencil_case(vdt)
    ring = kdia.dia_ring(lay, hw.H100_SMEM_PER_BLOCK)
    assert ring.step_rows == (1024 if bf16 else 512)
    y, written = ring_walk(lay, x, ring, ctas=ctas, xa=xa)
    assert torch.equal(y, kdia.spmv_dia_reference(lay, x))
    _close(y, y_jax)
    oracle = (mat.rounded() if bf16 else mat).matvec(x.numpy())
    wrong, rel = validate(y.numpy(), oracle)
    assert wrong == 0 and rel <= 1e-6, (wrong, rel)
    # The ring is written once a step plus the halo, and the entries of x
    # among them are what the counter reports.
    assert all(cnt == nt * ring.step_rows + 2114 for nt, cnt, _ in written)
    assert sum(st for _, _, st in written) == kdia.x_staged_floats(
        lay.offsets, ring, lay.m, lay.n, ctas)


@pytest.mark.parametrize("vdt", sorted(SPLIT_BUDGETS))
def test_plain_windowed_version_on_a_stencil(vdt):
    """The plain version through one window a tile (the CPU route of
    spmv_dia_windowed) gives spmv_dia_reference's bits and the JAX
    package's y."""
    _, lay, x, y_jax = _stencil_case(vdt)
    y = kdia.spmv_dia_windowed_reference(lay, x)
    assert torch.equal(y, kdia.spmv_dia_windowed(lay, x))
    assert torch.equal(y, kdia.spmv_dia_reference(lay, x))
    _close(y, y_jax)


@pytest.mark.parametrize("vdt", sorted(SPLIT_BUDGETS))
def test_a_budget_one_ring_misses_routes_resident(vdt, monkeypatch):
    """Where the split budgets once cut three segments, dia_ring refuses
    and dia_route sends the layout to spmv_dia (x past an L2 of 0)."""
    _, budget = SPLIT_BUDGETS[vdt]
    _, lay, _, _ = _stencil_case(vdt)
    assert _ring_at(lay, LANES).smem > budget
    with pytest.raises(ValueError, match="shared-memory budget"):
        kdia.dia_ring(lay, budget)
    monkeypatch.setattr(kdia, "dia_smem_budget", lambda device: budget)
    monkeypatch.setattr(hw, "H100_L2_BYTES", 0)
    route = kdia.dia_route(lay)
    assert route.kernel == "resident" and route.ring is None
