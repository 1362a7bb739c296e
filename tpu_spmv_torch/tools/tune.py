"""Cost-model calibration on the card (the port of `tpu_spmv.tools.tune`).

Measures every constant that steers the planner (tune/model.py) and the
solve choice (sts/solve.py) on the current card and writes them, keyed
by its name (hw.device_kind), to the table that hw.kernel_calibration
reads. The unit is the card's own: spmv_sell's time per sub-tile at a
chunk span of UNIT_SPAN blocks (unit_ns, its length, marks the unit).
The port's sell walk does not loop over the span (csrc/sell.cu), so the
reference's unit, a sub-tile's time over its span, shrank as a sample's
span grew and every constant grew with the sample; this one does not
depend on the sample. The protocol, all times warm in a CUDA graph
(bench/harness.bench_spmv):

  1. the unit and the span: spmv_sell on random bands whose chunk spans
     are SPANS blocks; its time per sub-tile is fitted to a + b * span,
     the unit is the fit at UNIT_SPAN, span_cost is b over the unit,
     sell_fixed what the model's sell sub-tile needs to equal the unit
     at UNIT_SPAN, span_limit the widest span whose time lies within
     SPAN_FIT of the fit; spmv_ranked on the narrowest and the widest
     band gives ranked_iter_cost, its time per sub-tile over sell's;
  2. ranked_fixed and pair_cost: spmv_ranked on column-binned layouts of
     a scattered sample (SCATTERED_COLS columns, so its bins fill alike
     at every scale) at W = RANKED_WIDTHS (16-bit window columns
     throughout, each sample 190 us or more at CALIB_SCALE), (pairs,
     time per sub-tile) fitted to ranked_fixed + pair_cost * pairs, the
     slope kept only where it exceeds twice its standard error;
  3. packed_over: spmv_packed against spmv_ranked on one narrow band,
     each the least of three timings taken in turns;
  4. epi_cost: spmv_ranked on the narrow band cut to 16 entries a row, as
     a ragged and as a uniform layout (the reference's step 4); a
     surcharge of 3 or 4 within NOISE of the sub-tile's time is 0;
  5. dia_step_cost: spmv_dia on DIA_OFFSETS constant diagonals, its time
     per 1024 rows and diagonal;
  6. traffic_floor: a ranked sub-tile's slab bytes (8 x 128 slots of a
     float32 value and an 8-bit column) at the rate the card reads a
     buffer (torch.sum over it);
  7. the solves: lower_solve_ranked and lower_solve_blocks on chains of
     chunks, each chunk reading the one before through CHAIN_SUBTILES
     sub-tiles a chunk; the time per chunk fitted to solve_<kernel>_link
     + solve_<kernel>_round * rounds (sts/solve.solve_cost);
  8. striped_bf16: spmv_striped on step 2's scattered sample cut into
     STRIPED_PASSES column stripes at W = STRIPED_WIDTH (a layout far
     past the L2, so the values stream from HBM as on the striped
     route), with f32 and with bf16 stripes, each the least of three
     timings taken in turns; the key is the bf16 time over the f32 time
     (1 within NOISE of 1), read by kernels/striped.bf16_pays.

Every constant but striped_bf16, a ratio of two times and no value in
the unit, is in the unit. The reference's constants, measured on a TPU
v5e in its own unit, are the lookup's defaults where an entry lacks a
key; striped_bf16's default, 1, keeps the reference's gate (no bf16
stripes). With `--device cpu` the plain PyTorch versions run, timed on
the host clock, at a small `--scale` (0.02): a check of the protocol,
whose numbers are not a card's. It then writes nothing unless
$TPU_SPMV_TORCH_CALIB names the file to write (keyed "cpu"). The
default --scale, CALIB_SCALE, is the one at which every sample takes 50
us or more on an H100.

Usage:
  python -m tpu_spmv_torch.tools.tune --calibrate            # measure + write
  python -m tpu_spmv_torch.tools.tune --calibrate --dry-run  # measure + print
  python -m tpu_spmv_torch.tools.tune --calibrate --scale 0.02 --device cpu
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import numpy as np
import torch


def fit_affine(points) -> tuple:
    """Least-squares (a, b) for t = a + b * p over (p, t) points."""
    pts = np.asarray(points, dtype=np.float64)
    if pts.shape[0] < 2:
        raise ValueError("need >= 2 (pairs, time) points to fit")
    A = np.stack([np.ones(pts.shape[0]), pts[:, 0]], axis=1)
    (a, b), *_ = np.linalg.lstsq(A, pts[:, 1], rcond=None)
    return float(a), float(b)


def calib_path() -> str:
    """The file --calibrate writes: $TPU_SPMV_TORCH_CALIB, else the user
    cache (hw.USER_CALIB)."""
    from tpu_spmv_torch import hw

    return os.environ.get(hw.CALIB_ENV, os.path.expanduser(hw.USER_CALIB))


def _seconds(fn, layout, x) -> float:
    """Seconds per call: warm CUDA-graph TimeMin on the card, the least of
    three host-clock calls on the CPU."""
    if x.device.type == "cuda":
        from tpu_spmv_torch.bench.harness import bench_spmv

        return bench_spmv(fn, layout, x, samples=5,
                          nnz=getattr(layout, "nnz", 1)).time_min
    fn(layout, x)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn(layout, x)
        times.append(time.perf_counter() - t0)
    return min(times)


def _paired(a, b, rounds: int = 3) -> tuple:
    """Seconds per call of two (fn, layout, x) calls whose difference is
    a constant (packed_over, epi_cost): each the least of `rounds`
    timings taken in turns, so a drift of the card's clock between them
    does not enter the difference."""
    times = [[], []]
    for _ in range(rounds):
        for out, (fn, lay, x) in zip(times, (a, b)):
            out.append(_seconds(fn, lay, x))
    return min(times[0]), min(times[1])


def _truncated(mat, longest: int):
    """The matrix with each row cut to its first `longest` entries."""
    from tpu_spmv_torch.formats.csr import CSRMatrix

    lens = mat.row_lengths.astype(np.int64)
    keep = (np.arange(mat.nnz) - np.repeat(
        mat.indptr[:-1].astype(np.int64), lens)) < longest
    indptr = np.zeros(mat.m + 1, np.int64)
    np.cumsum(np.minimum(lens, longest), out=indptr[1:])
    return CSRMatrix(indptr.astype(np.int32), mat.indices[keep],
                     mat.data[keep], mat.shape)


def _uniform_twin(mat):
    """The matrix with explicit zeros appended to the first row of each
    128-row chunk (at that row's last column, or column 0 for an empty
    row) up to the longest row: every chunk then has the same ordinal
    slab height, the operator is unchanged."""
    from tpu_spmv_torch.formats.csr import CSRMatrix
    from tpu_spmv_torch.formats.sell import LANES

    lens = mat.row_lengths.astype(np.int64)
    longest = int(lens.max())
    m = mat.m
    nch = -(-m // LANES)
    add = np.zeros(m, np.int64)
    first = np.arange(nch) * LANES
    add[first] = longest - lens[first]
    new_lens = lens + add
    indptr = np.zeros(m + 1, np.int64)
    np.cumsum(new_lens, out=indptr[1:])
    indices = np.empty(int(indptr[-1]), np.int32)
    data = np.zeros(int(indptr[-1]), np.float32)
    old = mat.indptr.astype(np.int64)
    pos = np.arange(mat.nnz) - np.repeat(old[:-1], lens) + np.repeat(
        indptr[:-1], lens)
    indices[pos] = mat.indices
    data[pos] = mat.data
    last = np.where(lens > 0, mat.indices[np.maximum(old[1:] - 1, 0)], 0)
    pad_pos = np.repeat(indptr[:-1] + lens, add) + (
        np.arange(int(add.sum())) - np.repeat(np.cumsum(add) - add, add))
    indices[pad_pos] = np.repeat(last, add)
    return CSRMatrix(indptr.astype(np.int32), indices, data, mat.shape)


# The sample scale --calibrate runs at by default.
CALIB_SCALE = 8.0
# Chunk spans (blocks) of the sell sweep, and the span of the unit.
SPANS = (8, 64, 256)
UNIT_SPAN = 8
# A sweep span whose time lies further than this from the affine fit is
# past the model's range (span_limit).
SPAN_FIT = 0.25
# A surcharge (packed_over, epi_cost) under this share of the sub-tile's
# time is within the spread of two timings of one sample (1-3% on an
# H100) and fits as 0.
NOISE = 0.02
# Column-bin widths of the ranked points: 16-bit window columns at each
# (an 8-bit layout, W <= 2, streams a byte less a slot).
RANKED_WIDTHS = (8, 16, 32, 64)
# Columns of the scattered sample from scale 8 on: its bins fill alike at
# every such scale, so its points do not move with the sample's size.
SCATTERED_COLS = 400_000
# Diagonal offsets of the DIA sample, and its most rows (x within the
# residency gate at every scale).
DIA_OFFSETS = (-2048, -1024, -2, -1, 0, 1, 2, 1024, 2048)
DIA_MAX_ROWS = 5_000_000
# Sub-tiles a chunk of the solve chains, and the chain's chunks at scale 1.
CHAIN_SUBTILES = (1, 4, 16)
CHAIN_CHUNKS = 128
# The bytes of a ranked sub-tile's slabs: 8 x 128 slots of a float32
# value and an 8-bit window column.
SUBTILE_BYTES = 8 * 128 * 5
# Column stripes and bin width of the striped sample (step 8): W = 64 is
# the width the planner gives scattered_16m on an H100.
STRIPED_PASSES = 3
STRIPED_WIDTH = 64
# Every key of a card's entry (hw.kernel_calibration).
KEYS = ("unit_ns", "ranked_fixed", "pair_cost", "ranked_iter_cost",
        "packed_over", "epi_cost", "sell_fixed", "span_cost",
        "traffic_floor", "span_limit", "dia_step_cost",
        "solve_ranked_link", "solve_ranked_round", "solve_blocks_link",
        "solve_blocks_round", "striped_bf16")


def _diagonals(m: int, offsets):
    """m x m CSRMatrix with constant diagonals at ascending `offsets`."""
    from tpu_spmv_torch.formats.csr import CSRMatrix

    cols = np.arange(m, dtype=np.int64)[:, None] + np.asarray(offsets)
    keep = (cols >= 0) & (cols < m)
    indptr = np.zeros(m + 1, np.int64)
    np.cumsum(keep.sum(1), out=indptr[1:])
    offs = np.broadcast_to(np.asarray(offsets), cols.shape)[keep]
    vals = np.where(offs == 0, 4.0, -0.5).astype(np.float32)
    return CSRMatrix(indptr, cols[keep].astype(np.int32), vals, (m, m))


@functools.lru_cache(maxsize=1)
def _dia_layout(rows: int):
    """The DIA sample's host layout: every scale from DIA_MAX_ROWS / 786432
    on measures the same one, built once."""
    from tpu_spmv_torch.formats.dia import DiaSlabs

    return DiaSlabs.from_csr(_diagonals(rows, DIA_OFFSETS))


def _band(m: int, band: int, per_row: int, seed: int):
    """m x m CSRMatrix of per_row random columns within `band` of the
    diagonal a row (sorted, duplicates kept): a random band without the
    symmetric generator's host cost."""
    from tpu_spmv_torch.formats.csr import CSRMatrix

    rng = np.random.default_rng(seed)
    rows = np.arange(m, dtype=np.int64)[:, None]
    cols = np.clip(rows + rng.integers(-band, band + 1, (m, per_row)), 0,
                   m - 1)
    cols.sort(axis=1)
    return CSRMatrix(np.arange(0, m * per_row + 1, per_row, dtype=np.int64),
                     cols.reshape(-1).astype(np.int32),
                     rng.standard_normal(m * per_row).astype(np.float32),
                     (m, m))


@functools.lru_cache(maxsize=len(CHAIN_SUBTILES))
def _chain_layout(chunks: int, subtiles: int):
    """chain_system's LowerSolveLayout on the host: every scale from 1 on
    measures the same chains, built once."""
    from tpu_spmv_torch.sts.solve import LowerSolveLayout

    sys_ = chain_system(chunks, subtiles)
    return LowerSolveLayout.build(sys_, np.ones(sys_.lower.m, np.float32),
                                  device="cpu")


def chain_system(chunks: int, subtiles: int):
    """A lower-triangular system of `chunks` packs of 128 rows, each row
    of a pack reading 8 * subtiles rows of the pack before: a chain of
    chunks, each chunk waiting on the one before and holding `subtiles`
    sub-tiles of slabs."""
    from tpu_spmv_torch.formats.csr import CSRMatrix
    from tpu_spmv_torch.sts.host import TriangularSystem

    per = 8 * subtiles
    m = chunks * 128
    r = np.arange(128, m, dtype=np.int64)
    rows = np.repeat(r, per)
    cols = (r[:, None] // 128 - 1) * 128 + (
        r[:, None] % 128 + np.arange(per)) % 128
    rows = np.concatenate([rows, np.arange(m)])
    cols = np.concatenate([cols.ravel(), np.arange(m)])
    vals = np.where(rows == cols, 1.0, -0.5 / per).astype(np.float32)
    low = CSRMatrix.from_coo(rows, cols, vals, (m, m))
    return TriangularSystem(
        matrix=low, lower=low, upper=low, perm=np.arange(m),
        pack_ptr=np.arange(0, m + 1, 128), order_type="LS", k=2)


def measure_points(scale: float = CALIB_SCALE, device=None, log=None) -> dict:
    """Run the calibration protocol (module doc) on `device` (default:
    the card; "cpu" runs the plain versions) at `scale` times the
    samples' base sizes. Returns the measured points, in seconds:

      sell      [(chunk span, s per sub-tile, sub-tiles)] of the sweep;
      ranked_span [(rank_nb, ranked s per sub-tile over sell's)] on the
                same bands;
      ranked    [(W, rank_nb, pairs, s per sub-tile, sub-tiles)];
      packed    (packed, ranked) s per sub-tile on the narrow band;
      epi       (ragged, uniform) (s per sub-tile, pairs, sub-tiles);
      dia       s per 1024 rows and diagonal;
      floor     s to read a ranked sub-tile's slabs;
      solve     {kernel: [(rounds a chunk, s per chunk)]};
      striped   (f32, bf16) s per spmv_striped call on the same stripes.

    The points are also printed, one line a step, to `log` (default
    stderr). Nothing is caught: a step that fails raises with its
    cause."""
    from tpu_spmv_torch.bench.matrices import random_banded, scattered_wide
    from tpu_spmv_torch.formats.packed import PackedRanked
    from tpu_spmv_torch.formats.sell import (
        LANES, SUBLANES, RankedSlabs, SellSlabs,
    )
    from tpu_spmv_torch.hw import target_device
    from tpu_spmv_torch.kernels.dia import spmv_dia
    from tpu_spmv_torch.kernels.packed import spmv_packed
    from tpu_spmv_torch.kernels.sell import spmv_ranked, spmv_sell
    from tpu_spmv_torch.kernels.striped import StripedRanked, spmv_striped
    from tpu_spmv_torch.kernels.sts import lower_solve_blocks, lower_solve_ranked
    from tpu_spmv_torch.sts.solve import SOLVE_GROUP

    dev = target_device(device)
    log = sys.stderr if log is None else log

    def say(text):
        print(text, file=log, flush=True)

    def xvec(n, seed):
        x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
        return torch.from_numpy(x).to(dev)

    def subtiles(lay):
        return int(lay.vals.shape[0]) // SUBLANES

    # 1. Sell over chunk spans, and ranked at the narrowest and widest.
    m = max(int(196608 * scale), 1024)
    sell, ranked_span = [], []
    for i, span in enumerate(SPANS):
        mb = _band(m, min((span - 1) * 64, m // 4), 12, seed=10 + i)
        xb = xvec(mb.n, 0)
        sl = SellSlabs.from_csr(mb).to(dev)
        t = _seconds(spmv_sell, sl, xb)
        sell.append((sl.max_nb, t / subtiles(sl), subtiles(sl)))
        text = (f"# span {sell[-1][0]}: sell {t * 1e6:.2f} us, "
                f"{sell[-1][1] * 1e9:.4f} ns a sub-tile ({sell[-1][2]} "
                f"sub-tiles, {mb.nnz} nnz)")
        del sl
        if span in (SPANS[0], SPANS[-1]):
            rl = RankedSlabs.from_csr(mb).to(dev)
            tr = _seconds(spmv_ranked, rl, xb)
            ranked_span.append((rl.rank_nb, tr / subtiles(rl) / sell[-1][1]))
            text += (f"; ranked {tr * 1e6:.2f} us, rank_nb {rl.rank_nb}, "
                     f"{tr / subtiles(rl) * 1e9:.4f} ns a sub-tile "
                     f"({subtiles(rl)} sub-tiles)")
            del rl
        say(text)

    # 2. Ranked sub-tiles over column bins of a scattered sample.
    mg = scattered_wide(int(100_000 * scale),
                        int(SCATTERED_COLS * min(scale / 8, 1.0)), 8, seed=2)
    xg = xvec(mg.n, 1)
    ranked = []
    for w in RANKED_WIDTHS:
        try:
            lay = RankedSlabs.from_csr(mg, bin_blocks=w).to(dev)
        except ValueError as e:
            say(f"# W={w}: skipped ({e})")
            continue
        t = _seconds(spmv_ranked, lay, xg)
        pairs = max((lay.rank_nb + 1) // 2, 1)
        ranked.append((w, lay.rank_nb, pairs, t / subtiles(lay),
                       subtiles(lay)))
        say(f"# W={w}: rank_nb={lay.rank_nb} pairs={pairs} "
            f"{ranked[-1][3] * 1e9:.4f} ns a sub-tile ({t * 1e6:.2f} us, "
            f"{subtiles(lay)} sub-tiles)")
        del lay

    # 3. Packed against ranked on one narrow band (rank_nb ~2, where the
    # surcharge is most of a sub-tile).
    mn = random_banded(int(262144 * scale), 96, 5, seed=4)
    xn = xvec(mn.n, 2)
    rl = RankedSlabs.from_csr(mn).to(dev)
    pk = PackedRanked.from_csr(mn).to(dev)
    tp, tr = _paired((spmv_packed, pk, xn), (spmv_ranked, rl, xn))
    packed = (tp / subtiles(pk), tr / subtiles(rl))
    say(f"# packed: {tp * 1e6:.2f} us, {packed[0] * 1e9:.4f} ns a sub-tile "
        f"against ranked {tr * 1e6:.2f} us, {packed[1] * 1e9:.4f} ns "
        f"({subtiles(pk)} and {subtiles(rl)} sub-tiles)")
    del rl, pk

    # 4. The same narrow band, its rows cut to two sub-tiles (a few long
    # rows would otherwise set every chunk's height in the uniform twin),
    # as a ragged and as a uniform layout.
    me = _truncated(mn, 2 * SUBLANES)
    rag = RankedSlabs.from_csr(me, align=False)
    uni = RankedSlabs.from_csr(_uniform_twin(me), align=False)
    if rag.chunk_q or not uni.chunk_q:
        raise RuntimeError(
            f"epi_cost sample: chunk_q {rag.chunk_q} (ragged) and "
            f"{uni.chunk_q} (uniform); the ragged layout must have 0")
    rag, uni = rag.to(dev), uni.to(dev)
    epi = [(t / subtiles(lay), max((lay.rank_nb + 1) // 2, 1), subtiles(lay))
           for lay, t in zip((rag, uni), _paired((spmv_ranked, rag, xn),
                                                 (spmv_ranked, uni, xn)))]
    say(f"# epi: ragged {epi[0][0] * 1e9:.4f} ns a sub-tile ({epi[0][2]} "
        f"sub-tiles, pairs {epi[0][1]}), uniform {epi[1][0] * 1e9:.4f} "
        f"({epi[1][2]} sub-tiles, chunk_q {uni.chunk_q}, pairs "
        f"{epi[1][1]})")
    del rag, uni

    # 5. DIA: constant diagonals, x within the residency gate.
    rows = min(int(786432 * scale), DIA_MAX_ROWS)
    dl = _dia_layout(rows).to(dev)
    t = _seconds(spmv_dia, dl, xvec(rows, 3))
    dia = t / (-(-rows // 1024) * len(DIA_OFFSETS))
    say(f"# dia: {t * 1e6:.2f} us on {len(DIA_OFFSETS)} diagonals of "
        f"{rows} rows, {dia * 1e9:.4f} ns per 1024 rows and diagonal")
    del dl

    # 6. The card's read rate.
    buf = torch.ones(max(int(16_000_000 * scale), 1 << 16), device=dev)
    t = _seconds(lambda _, b: b.sum(), None, buf)
    rate = buf.numel() * 4 / t
    floor = SUBTILE_BYTES / rate
    say(f"# read rate: {rate / 1e9:.1f} GB/s ({buf.numel() * 4 / 2**20:.0f} "
        f"MB in {t * 1e6:.2f} us), {floor * 1e9:.4f} ns a ranked sub-tile's "
        f"{SUBTILE_BYTES} bytes")
    del buf

    # 7. The solves on chains of chunks.
    chunks = max(int(CHAIN_CHUNKS * min(scale, 1.0)), 8)
    solve = {"ranked": [], "blocks": []}
    for sub in CHAIN_SUBTILES:
        lay = _chain_layout(chunks, sub).to(dev)
        if lay.ranked is None:
            raise RuntimeError(f"chain of {sub} sub-tiles: no ranked layout")
        for kernel, fn, slabs in (("ranked", lower_solve_ranked, lay.ranked),
                                  ("blocks", lower_solve_blocks, lay.slabs)):
            cp = slabs.chunk_ptr.cpu().numpy().astype(np.int64)
            rounds = float(np.mean(-(-np.diff(cp) // SOLVE_GROUP)))
            t = _seconds(lambda sl, b: fn(sl, b.view(-1, 128)), slabs,
                         lay.b_scale.reshape(-1))
            solve[kernel].append((rounds, t / chunks))
        say(f"# chain of {chunks} chunks, {sub} sub-tiles a chunk: " + ", ".join(
            f"{k} {solve[k][-1][1] * 1e9:.1f} ns a chunk ({solve[k][-1][0]:g} "
            "rounds)" for k in solve))
        del lay

    # 8. Striped passes over step 2's sample, f32 against bf16 stripes.
    sc = -(-mg.n // (STRIPED_PASSES * LANES)) * LANES
    f32, b16 = (StripedRanked.from_csr(mg, stripe_cols=sc,
                                       bin_blocks=STRIPED_WIDTH,
                                       val_dtype=vdt, device=dev)
                for vdt in (None, torch.bfloat16))
    striped = _paired((spmv_striped, f32, xg), (spmv_striped, b16, xg))
    say(f"# striped: P={f32.num_stripes} stripes of {sc} columns, "
        f"W={STRIPED_WIDTH}: f32 {striped[0] * 1e6:.2f} us "
        f"({f32.nbytes / 2**20:.1f} MB), bf16 {striped[1] * 1e6:.2f} us "
        f"({b16.nbytes / 2**20:.1f} MB), bf16 / f32 "
        f"{striped[1] / striped[0]:.4f}")
    del f32, b16
    return dict(sell=sell, ranked_span=ranked_span, ranked=ranked,
                packed=packed, epi=tuple(epi), dia=dia, floor=floor,
                solve=solve, striped=striped)


def _slope_error(points) -> float:
    """The standard error of fit_affine's slope over (x, y) points (inf
    with two points or fewer, or one x)."""
    pts = np.asarray(points, dtype=np.float64)
    spread = np.sum((pts[:, 0] - pts[:, 0].mean()) ** 2)
    if pts.shape[0] <= 2 or spread == 0:
        return float("inf")
    a, b = fit_affine(points)
    resid = pts[:, 1] - (a + b * pts[:, 0])
    return float(np.sqrt(resid @ resid / (pts.shape[0] - 2) / spread))


def _sig(v: float) -> float:
    return float(f"{v:.4g}")


def fit(points: dict) -> dict:
    """The card's entry (KEYS) from measure_points' points: every
    constant in the unit, spmv_sell's time per sub-tile at UNIT_SPAN
    (module doc). Fitted slopes and costs are floored at 0, pair_cost is
    0 unless its slope exceeds twice its standard error, and a
    surcharge within NOISE of its sub-tile's time is 0. striped_bf16 is
    the bf16 stripes' time over the f32 stripes' (no unit), 1 within
    NOISE of 1."""
    a, b = fit_affine([(s, t) for s, t, _ in points["sell"]])
    unit = a + b * UNIT_SPAN
    span_cost = max(b / unit, 0.0)
    floor = points["floor"] / unit
    inside = [s for s, t, _ in points["sell"]
              if abs(t - (a + b * s)) <= SPAN_FIT * (a + b * s)]
    ranked = [(p, t / unit) for _, _, p, t, _ in points["ranked"]]
    fixed, pair = fit_affine(ranked)
    if pair < 2.0 * _slope_error(ranked):
        # No rise with the window that the points resolve: flat.
        fixed, pair = float(np.mean([t for _, t in ranked])), 0.0
    pu, ru = (t / unit for t in points["packed"])
    (rag, p_rag, _), (uni, p_uni, _) = points["epi"]
    epi = (rag / unit - pair * p_rag) - (uni / unit - pair * p_uni)
    if abs(pu - ru) < NOISE * ru:
        pu = ru
    if abs(epi) < NOISE * uni / unit:
        epi = 0.0
    out = dict(
        unit_ns=unit * 1e9,
        ranked_fixed=max(fixed, 0.0),
        pair_cost=pair,
        ranked_iter_cost=float(np.mean([r for _, r in points["ranked_span"]])),
        packed_over=max(pu - ru, 0.0),
        epi_cost=max(epi, 0.0),
        sell_fixed=max(1.0 - max(span_cost * UNIT_SPAN, floor), 0.0),
        span_cost=span_cost,
        traffic_floor=floor,
        span_limit=float(max(inside)),
        dia_step_cost=points["dia"] / unit,
    )
    for kernel, pts in points["solve"].items():
        link, per_round = fit_affine(pts)
        out[f"solve_{kernel}_link"] = max(link, 0.0) / unit
        out[f"solve_{kernel}_round"] = max(per_round, 0.0) / unit
    t32, t16 = points["striped"]
    out["striped_bf16"] = 1.0 if abs(t16 - t32) < NOISE * t32 else t16 / t32
    return {k: _sig(out[k]) for k in KEYS}


def measure(scale: float = CALIB_SCALE, device=None) -> dict:
    """The calibration protocol's constants (fit of measure_points)."""
    return fit(measure_points(scale, device))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--calibrate", action="store_true", required=True)
    ap.add_argument("--dry-run", action="store_true",
                    help="measure and print; do not write the file")
    ap.add_argument("--scale", type=float, default=CALIB_SCALE,
                    help="sample-size factor (CPU check: 0.02)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu runs the plain PyTorch versions, timed on the "
                    "host clock")
    args = ap.parse_args(argv)

    from tpu_spmv_torch import hw

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "no CUDA device: calibration measures a card (use --device cpu "
            "--scale 0.02 for a CPU check of the protocol)"
        )
    consts = measure(scale=args.scale, device=args.device)
    kind = hw.device_kind() if args.device == "cuda" else "cpu"
    print(json.dumps({kind: consts}))
    if args.dry_run:
        return 0
    if args.device == "cpu" and not os.environ.get(hw.CALIB_ENV):
        print(f"# host-clock numbers of the plain versions: not written "
              f"(set ${hw.CALIB_ENV} to write them)", file=sys.stderr)
        return 0
    path = calib_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    table = {}
    try:
        with open(path) as f:
            table = json.load(f)
    except (OSError, ValueError):
        pass
    table[kind] = consts
    with open(path, "w") as f:
        json.dump(table, f, indent=1)
    print(f"# wrote {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
