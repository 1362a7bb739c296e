"""The ring of spmv_dia_windowed (csrc/windowed.cu's dia_ring_kernel) on
the CPU: its host sizing (kernels/dia.dia_ring) and a step-by-step model
of the walk in plain torch.

The sizing: the step S is a multiple of 128 that divides the layout's
tile, at most DIA_STEP_ROWS, and the largest whose ring and two stages
fit the budget; the ring holds W >= span + 2S floats, a multiple of 32,
so every bulk copy into it is 16-byte aligned; the refusal names the
bytes of 128 rows a step.

The model walks each CTA's contiguous steps as the kernel does: the
producer stages step t + 1 (its D value runs, and the S entries of x
past step t's window, the whole window of S + span at a CTA's first
step) before the consumers read step t, the most the kernel's barriers
let it run ahead; x goes into ring slot (g + xa - ubase) mod W, its
16-byte
aligned part in one bulk copy or two where it wraps the ring (each
checked aligned), the unaligned ends and the entries outside [0, n) by
"lanes" (0 outside). The ring starts as NaN, so a read of a slot never
written, or overwritten too early, shows. Its result is held to
spmv_dia_reference and to the JAX package's spmv_dia_windowed (Pallas,
interpret mode) on the same layout: RelL2 <= 1e-6 and Number Wrong 0
against each (the model adds in float32 without fused multiply-adds, the
kernel with them); bf16 layouts against CSRMatrix.rounded. Cases:
offsets with no multiple of 4, positive and negative offsets only, n not
a multiple of 128 (a partial last step), steps that end at a tile's end
(S = the tile) and inside it, x at each 4-byte offset from a 16-byte
boundary, and CTA counts from one to more than the steps.
"""

import dataclasses

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
from tpu_spmv_torch.formats.convert import from_reference
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
    lay = SIZINGS[case][0]()
    need = kdia._ring_at(lay, LANES).smem
    assert kdia.dia_ring(lay, need).step_rows == LANES
    with pytest.raises(ValueError, match=f"{need} bytes at 128 rows a step"):
        kdia.dia_ring(lay, need - 1)


def ring_walk(lay, x, ring, ctas, xa=0):
    """y by the kernel's walk (see the module docstring), and the x
    entries each CTA wrote into its ring."""
    S, W = ring.step_rows, ring.ring
    offs = list(lay.offsets)
    dk = [o - offs[0] for o in offs]
    span = dk[-1]
    _, D, rb, _ = lay.vals.shape
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
        ubase = (i0 * S + offs[0] + xa) // 4 * 4
        buf = torch.full((W,), float("nan"))
        stage = {}
        count = [0]

        def produce(t):
            r0 = (i0 + t) * S
            lo = r0 + offs[0] + (span if t else 0)
            hi = r0 + S + offs[0] + span
            c0, c1 = max(lo, 0), min(hi, n)
            ga = gb = hi
            if c1 > c0:
                ua, ub = -(-(c0 + xa) // 4) * 4, (c1 + xa) // 4 * 4
                if ub > ua:
                    ga, gb = ua - xa, ub - xa
            tt, blk = divmod(r0, tile)
            stage[t % 2] = vals[tt, :, blk // LANES:(blk + S) // LANES].reshape(
                D, S)
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

        def consume(t):
            r0 = (i0 + t) * S
            pos0 = (r0 + offs[0] + xa - ubase) % W
            rows = min(S, m - r0)
            i = torch.arange(rows)
            acc = torch.zeros(rows)
            for k in range(D):
                q = pos0 + i + dk[k]
                q = torch.where(q >= W, q - W, q)
                acc = acc + stage[t % 2][k, :rows] * buf[q]
            y[r0:r0 + rows] = acc

        produce(0)
        for t in range(i1 - i0):
            if t + 1 < i1 - i0:
                produce(t + 1)  # the producer runs one step ahead
            consume(t)
        written.append((i1 - i0, count[0]))
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
    assert all(cnt == nt * rows + span for nt, cnt in written)
    assert sum(nt for nt, _ in written) == -(-mat.m // rows)
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
