"""The ring of spmv_dia_windowed (csrc/windowed.cu's dia_ring_kernel) on
the CPU: its host sizing (kernels/dia.dia_ring) and a step-by-step model
of the walk in plain torch.

The sizing: the fewest segments (runs of consecutive offsets, cut at
the largest gaps), and at that cut the step S, a multiple of 128 that
divides the layout's tile, at most DIA_STEP_ROWS, and the largest whose
rings and two stages fit the budget; each segment's ring holds W >=
span + 2S floats of the widest segment, a multiple of 32, so every bulk
copy into it is 16-byte aligned; a layout whose one ring fits keeps it
as it was; the refusal names the least bytes of 128 rows a step over
every cut. HPCG's 256^3 operator is planned from its offsets alone.

The model walks each CTA's contiguous steps as the kernel does: the
producer stages step t + 1 (its D value runs, and for each segment the
S entries of x past step t's window, the whole window of S + span at a
CTA's first step) before the consumers read step t, the most the
kernel's barriers let it run ahead; x goes into slot (g + xa - ubase)
mod W of the segment's ring, its 16-byte aligned part in one bulk copy or two where it wraps the ring (each
checked aligned), the unaligned ends and the entries outside [0, n) by
"lanes" (0 outside). The ring starts as NaN, so a read of a slot never
written, or overwritten too early, shows. Its result is held to
spmv_dia_reference and to the JAX package's spmv_dia_windowed (Pallas,
interpret mode) on the same layout: RelL2 <= 1e-6 and Number Wrong 0
against each (the model adds in float32 without fused multiply-adds, the
kernel with them); bf16 layouts against CSRMatrix.rounded; a ring cut
into segments bit for bit against spmv_dia_reference. Cases:
offsets with no multiple of 4, positive and negative offsets only, n not
a multiple of 128 (a partial last step), steps that end at a tile's end
(S = the tile) and inside it, x at each 4-byte offset from a 16-byte
boundary, and CTA counts from one to more than the steps.
"""

import dataclasses
import functools
import itertools

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

from test_torch_gpu import DIAGONALS, diagonal_matrix


def _ring_fits(lay, rows, budget):
    return kdia._ring_at(lay, rows).smem <= budget


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
    # One ring fits, so the layout keeps it, as it was before segments.
    assert ring.segments == (0,) and ring == kdia._ring_at(lay, S)
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


def _least_at_128(lay):
    return min(kdia._ring_at(lay, LANES, f).smem
               for f in kdia.ring_splits(lay.offsets))


@pytest.mark.parametrize("case", sorted(SIZINGS))
def test_dia_ring_refuses_when_128_rows_do_not_fit(case):
    """The refusal comes only when no cut into segments, up to one an
    offset, fits at 128 rows; it names the least bytes over the cuts."""
    lay = SIZINGS[case][0]()
    need = _least_at_128(lay)
    assert need <= kdia._ring_at(lay, LANES).smem
    assert kdia.dia_ring(lay, need).step_rows == LANES
    with pytest.raises(ValueError, match=f"{need} bytes at 128 rows a step"):
        kdia.dia_ring(lay, need - 1)


def ring_walk(lay, x, ring, ctas, xa=0):
    """y by the kernel's walk (see the module docstring), and for each
    CTA (its steps, the entries it wrote into its rings, the entries of
    x among them)."""
    S, W = ring.step_rows, ring.ring
    offs = list(lay.offsets)
    _, D, rb, _ = lay.vals.shape
    firsts = list(ring.segments)
    ends = firsts[1:] + [D]
    segs = [(offs[f], offs[e - 1] - offs[f]) for f, e in zip(firsts, ends)]
    seg_of = [c for c, (f, e) in enumerate(zip(firsts, ends))
              for _ in range(f, e)]
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
        ubase = [(i0 * S + lo + xa) // 4 * 4 for lo, _ in segs]
        e = [i0 * S + lo + xa - u for (lo, _), u in zip(segs, ubase)]
        # Each diagonal's slot past pos0 in its segment's ring.
        dk = [offs[k] - segs[seg_of[k]][0] + e[seg_of[k]] for k in range(D)]
        buf = torch.full((len(segs), W), float("nan"))
        stage = {}
        count = [0, 0]

        def produce(t):
            r0 = (i0 + t) * S
            tt, blk = divmod(r0, tile)
            stage[t % 2] = vals[tt, :, blk // LANES:(blk + S) // LANES].reshape(
                D, S)
            for c, (low, span) in enumerate(segs):
                lo = r0 + low + (span if t else 0)
                hi = r0 + S + low + span
                c0, c1 = max(lo, 0), min(hi, n)
                ga = gb = hi
                if c1 > c0:
                    ua, ub = -(-(c0 + xa) // 4) * 4, (c1 + xa) // 4 * 4
                    if ub > ua:
                        ga, gb = ua - xa, ub - xa
                if gb > ga:
                    p = (ga + xa - ubase[c]) % W
                    first = min(gb - ga, W - p)
                    for dst, src, cnt in ((p, ga, first),
                                          (0, ga + first, gb - ga - first)):
                        if cnt:
                            assert dst % 4 == 0 and (src + xa) % 4 == 0
                            assert cnt % 4 == 0
                            buf[c, dst:dst + cnt] = x[src:src + cnt]
                for g in [*range(lo, ga), *range(gb, hi)]:
                    buf[c, (g + xa - ubase[c]) % W] = (
                        float(x[g]) if 0 <= g < n else 0.0)
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
                acc = acc + stage[t % 2][k, :rows] * buf[seg_of[k], q]
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
    assert ring.segments == (0,)
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


def test_hpcg_256_takes_three_segments_from_its_offsets_alone():
    """NVIDIA's HPCG grid, 256^3 a GPU: one ring over every offset needs
    ~555 KB at 128 rows; one segment a z-plane (offsets dz * 65,536 +
    {-257 ... 257}, span 514) fits at S = 512, and each segment stages x
    about once."""
    offs = _hpcg_offsets(256)
    n = 256 ** 3
    assert max(offs) - min(offs) == 131_586
    one = kdia._ring_size(offs, 4, LANES)
    assert one.smem > 555_000 > hw.H100_SMEM_PER_BLOCK
    ring = kdia.ring_plan(offs, 32768, 4, hw.H100_SMEM_PER_BLOCK, 1024)
    assert ring.segments == (0, 9, 18)
    assert ring.step_rows == 512
    assert ring.ring == 1568 == -(-(514 + 2 * 512) // 32) * 32
    assert ring.smem == 3 * 4 * 1568 + 2 * 27 * 512 * 4 + 4 * 27
    assert 125_000 < ring.smem <= hw.H100_SMEM_PER_BLOCK
    # One CTA stages each plane's window once: x whole, less the rows
    # the outer planes' windows leave outside [0, n).
    assert kdia.x_staged_floats(offs, ring, n, n, 1) == 3 * n - 2 * (
        65_536 - 257)
    # The H100's 132 SMs, a CTA each at this shared memory: ~3 n.
    assert 3.0 < kdia.x_staged_floats(offs, ring, n, n, 132) / n < 3.05


@pytest.mark.parametrize("offs,tile,elem,segments,rows", [
    ((-4096, -1, 0, 1, 4096), 32768, 4, (0,), 1024),  # lap2d_4096 f32
    ((-4096, -1, 0, 1, 4096), 65536, 2, (0,), 1024),  # lap2d_4096 bf16
    (_hpcg_offsets(104), 32768, 4, (0,), 512),  # HPCG's 104^3 grid
    (_hpcg_offsets(160), 32768, 4, (0, 9, 18), 512),  # the smallest split
])
def test_the_fewest_segments_that_fit(offs, tile, elem, segments, rows):
    ring = kdia.ring_plan(offs, tile, elem, hw.H100_SMEM_PER_BLOCK, 1024)
    assert (ring.segments, ring.step_rows) == (segments, rows)
    if segments == (0,):  # the ring as it was before segments
        assert ring == kdia._ring_size(offs, elem, rows)


def test_splits_cut_at_the_largest_gaps_first():
    # Gaps 297, 2, 1, 2, 498, 1 before diagonals 1 to 6.
    offs = (-300, -3, -1, 0, 2, 500, 501)
    assert kdia.ring_splits(offs) == [
        (0,), (0, 5), (0, 1, 5), (0, 1, 2, 5), (0, 1, 2, 4, 5),
        (0, 1, 2, 3, 4, 5), (0, 1, 2, 3, 4, 5, 6)]


def test_the_ring_is_planned_once_in_its_phase_span(monkeypatch):
    """spmv_dia_windowed's launch plan (the ring, the C entry's sizes and
    the call's counters) is made once per layout shape, budget and card,
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
        assert first.counters == {
            "dia.ring_segments": 1, "dia.ring_smem_bytes": ring.smem,
            "dia.step_rows": ring.step_rows,
            "dia.x_staged_floats": kdia.x_staged_floats(
                lay.offsets, ring, lay.m, lay.n, 5)}
    finally:
        kdia._launch_plan.cache_clear()
        obs.reset()


# A 32 x 32 x 4 grid: planes 1,024 rows apart, so one ring spans 2,114
# entries and three, one a plane, 66 each. The budgets fit three rings at
# 128 rows and not one.
SPLIT_BUDGETS = {"f32": (False, 35_000), "bf16": (True, 20_000)}


@functools.lru_cache(maxsize=None)
def _split_case(vdt):
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
def test_segmented_walk_is_the_plain_versions_bits(vdt, ctas, xa):
    bf16, budget = SPLIT_BUDGETS[vdt]
    mat, lay, x, y_jax = _split_case(vdt)
    assert kdia._ring_at(lay, LANES).smem > budget
    ring = kdia.dia_ring(lay, budget)
    assert ring.segments == (0, 9, 18) and ring.step_rows == LANES
    y, written = ring_walk(lay, x, ring, ctas=ctas, xa=xa)
    ref = kdia.spmv_dia_reference(lay, x)
    assert torch.equal(y, ref)
    _close(y, y_jax)
    oracle = (mat.rounded() if bf16 else mat).matvec(x.numpy())
    wrong, rel = validate(y.numpy(), oracle)
    assert wrong == 0 and rel <= 1e-6, (wrong, rel)
    # Every segment's ring is written once a step plus its halo, and the
    # entries of x among them are what the counter reports.
    assert all(cnt == 3 * nt * LANES + 3 * 66 for nt, cnt, _ in written)
    assert sum(st for _, _, st in written) == kdia.x_staged_floats(
        lay.offsets, ring, lay.m, lay.n, ctas)


@pytest.mark.parametrize("vdt", sorted(SPLIT_BUDGETS))
def test_plain_windowed_version_walks_the_segments(vdt):
    """The plain version through the ring's three windows, one a
    segment, gives the bits of one window over the whole band (its
    default, and the CPU route of spmv_dia_windowed) and of
    spmv_dia_reference, and the JAX package's y."""
    bf16, budget = SPLIT_BUDGETS[vdt]
    mat, lay, x, y_jax = _split_case(vdt)
    segments = kdia.dia_ring(lay, budget).segments
    assert segments == (0, 9, 18)
    y = kdia.spmv_dia_windowed_reference(lay, x, segments)
    assert torch.equal(y, kdia.spmv_dia_windowed_reference(lay, x))
    assert torch.equal(y, kdia.spmv_dia_windowed(lay, x))
    assert torch.equal(y, kdia.spmv_dia_reference(lay, x))
    _close(y, y_jax)
