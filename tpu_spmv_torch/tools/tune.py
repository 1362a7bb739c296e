"""Cost-model calibration on the card (the port of `tpu_spmv.tools.tune`).

Measures the planner's constants (tune/model.py) on the current card and
writes them, keyed by its name (hw.device_kind), to the table that
hw.kernel_calibration reads. The protocol is the reference's:

  1. the unit, one plain gather iteration: spmv_sell on a wide-band
     sample, time per sub-tile over its chunk span (max_nb);
  2. ranked_fixed and pair_cost: spmv_ranked on column-binned layouts
     of a scattered sample at W = 2, 4, 8, 16; each W fixes the pairs of
     gather iterations, and the (pairs, time per sub-tile / unit) points
     are fitted to t = ranked_fixed + pair_cost * pairs;
  3. packed_over: spmv_packed against spmv_ranked on one narrow-band
     sample, the difference of their times per sub-tile over the unit;
  4. epi_cost, which the reference leaves to its default: spmv_ranked on
     the narrow-band sample, its rows cut to 16 entries, as a ragged
     layout (ordinal slots, chunks of one or two sub-tiles) and as a
     uniform one (one row of each chunk padded with explicit zeros to the
     longest row, so every chunk holds two sub-tiles), the difference of
     their times per sub-tile over the unit, less the fitted pair cost of
     any difference in rank.

Times are warm, in a CUDA graph (bench/harness.bench_spmv). With
`--device cpu` the plain PyTorch versions run, timed on the host clock,
at a small `--scale` (0.02): a check of the protocol, whose numbers are
not a card's. It then writes nothing unless $TPU_SPMV_TORCH_CALIB names
the file to write (keyed "cpu").

Usage:
  python -m tpu_spmv_torch.tools.tune --calibrate            # measure + write
  python -m tpu_spmv_torch.tools.tune --calibrate --dry-run  # measure + print
  python -m tpu_spmv_torch.tools.tune --calibrate --scale 0.02 --device cpu
"""

from __future__ import annotations

import argparse
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

        return bench_spmv(fn, layout, x, samples=5).time_min
    fn(layout, x)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn(layout, x)
        times.append(time.perf_counter() - t0)
    return min(times)


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


def measure_points(scale: float = 1.0, device=None, log=None) -> dict:
    """Run the calibration protocol (module doc) on `device` (default:
    the card; "cpu" runs the plain versions) at `scale` times the
    reference's sample sizes. Returns the measured points:

      unit      seconds of one plain gather iteration (unit_span: the
                span of the sample it was measured on);
      ranked    [(W, rank_nb, pairs, units per sub-tile, sub-tiles)];
      packed    (packed, ranked) units per sub-tile on the narrow sample;
      epi       (ragged, uniform) units per sub-tile, and their pairs.

    The points are also printed, one line a step, to `log` (default
    stderr). Nothing is caught: a step that fails raises with its
    cause."""
    from tpu_spmv_torch.bench.matrices import random_banded, random_general
    from tpu_spmv_torch.formats.packed import PackedRanked
    from tpu_spmv_torch.formats.sell import SUBLANES, RankedSlabs, SellSlabs
    from tpu_spmv_torch.hw import target_device
    from tpu_spmv_torch.kernels.packed import spmv_packed
    from tpu_spmv_torch.kernels.sell import spmv_ranked, spmv_sell
    from tpu_spmv_torch.reorder import rcm as rcm_fn

    dev = target_device(device)
    log = sys.stderr if log is None else log

    def xvec(n, seed):
        x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
        return torch.from_numpy(x).to(dev)

    def subtiles(lay):
        return int(lay.vals.shape[0]) // SUBLANES

    # 1. The unit: a wide band, so the span dominates a sub-tile's time.
    mb = random_banded(int(65536 * scale), int(2048 * scale) + 64, 12, seed=0)
    mb = mb.permuted(rcm_fn(mb.indptr, mb.indices))
    sl = SellSlabs.from_csr(mb).to(dev)
    t = _seconds(spmv_sell, sl, xvec(mb.n, 0))
    unit, span = t / (subtiles(sl) * max(sl.max_nb, 1)), sl.max_nb
    print(f"# unit: {unit * 1e9:.4f} ns a plain iteration (sell "
          f"{t * 1e6:.2f} us, span {sl.max_nb}, {subtiles(sl)} sub-tiles, "
          f"{mb.nnz} nnz)", file=log, flush=True)
    del sl

    # 2. Ranked sub-tiles over column bins of a scattered sample.
    mg = random_general(int(50_000 * scale), 8, seed=2)
    xg = xvec(mg.n, 1)
    ranked = []
    for w in (2, 4, 8, 16):
        try:
            lay = RankedSlabs.from_csr(mg, bin_blocks=w).to(dev)
        except ValueError as e:
            print(f"# W={w}: skipped ({e})", file=log, flush=True)
            continue
        t = _seconds(spmv_ranked, lay, xg)
        pairs = max((lay.rank_nb + 1) // 2, 1)
        units = t / subtiles(lay) / unit
        ranked.append((w, lay.rank_nb, pairs, units, subtiles(lay)))
        print(f"# W={w}: rank_nb={lay.rank_nb} pairs={pairs} {units:.3f} "
              f"units/sub-tile ({t * 1e6:.2f} us, {subtiles(lay)} sub-tiles)",
              file=log, flush=True)

    # 3. Packed against ranked on one narrow band (rank_nb ~2, where the
    # surcharge is most of a sub-tile).
    mn = random_banded(int(262144 * scale), 96, 5, seed=4)
    mn = mn.permuted(rcm_fn(mn.indptr, mn.indices))
    xn = xvec(mn.n, 2)
    rl = RankedSlabs.from_csr(mn).to(dev)
    ru = _seconds(spmv_ranked, rl, xn) / subtiles(rl) / unit
    pk = PackedRanked.from_csr(mn).to(dev)
    pu = _seconds(spmv_packed, pk, xn) / subtiles(pk) / unit
    print(f"# packed: {pu:.3f} units/sub-tile against ranked {ru:.3f} "
          f"({subtiles(pk)} and {subtiles(rl)} sub-tiles)", file=log,
          flush=True)
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
    epi = []
    for lay in (rag, uni):
        lay = lay.to(dev)
        epi.append((_seconds(spmv_ranked, lay, xn) / subtiles(lay) / unit,
                    max((lay.rank_nb + 1) // 2, 1), subtiles(lay)))
    print(f"# epi: ragged {epi[0][0]:.3f} units/sub-tile ({epi[0][2]} "
          f"sub-tiles, pairs {epi[0][1]}), uniform {epi[1][0]:.3f} "
          f"({epi[1][2]} sub-tiles, chunk_q {uni.chunk_q}, pairs "
          f"{epi[1][1]})", file=log, flush=True)
    return dict(unit=unit, unit_span=span, ranked=ranked, packed=(pu, ru),
                epi=tuple(epi))


def fit(points: dict) -> dict:
    """The constants from measure_points' points, with the reference's
    floors (ranked_fixed >= 0.1, pair_cost >= 0.05, packed_over >= 0.1,
    ranked_iter_cost >= 1) and epi_cost >= 0."""
    fixed, pair = fit_affine([(p, u) for _, _, p, u, _ in points["ranked"]])
    pu, ru = points["packed"]
    (rag, p_rag, _), (uni, p_uni, _) = points["epi"]
    pair_f = max(pair, 0.05)
    epi = (rag - pair_f * p_rag) - (uni - pair_f * p_uni)
    return {
        "ranked_fixed": round(max(fixed, 0.1), 3),
        "pair_cost": round(pair_f, 3),
        "ranked_iter_cost": round(max(pair, 1.0), 3),
        "packed_over": round(max(pu - ru, 0.1), 3),
        "epi_cost": round(max(epi, 0.0), 3),
    }


def measure(scale: float = 1.0, device=None) -> dict:
    """The calibration protocol's constants (fit of measure_points)."""
    return fit(measure_points(scale, device))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--calibrate", action="store_true", required=True)
    ap.add_argument("--dry-run", action="store_true",
                    help="measure and print; do not write the file")
    ap.add_argument("--scale", type=float, default=1.0,
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
