"""The port's flagship benchmark: bench.py's sequence on the card.

    python -m tpu_spmv_torch.bench.flagship [--device cuda|cpu]

The matrix is the 5-point Laplacian of a 1024 x 1024 grid (1.05M rows,
5.2M nnz; TPU_SPMV_BENCH_N sets the grid side), as in bench.py:

  1. after RCM, the kernel tune/model.tpu_plan picks (packed or ranked; sell where
     a ranked or packed build fails), then the packed candidate and the
     bf16-values candidate of the kernel in hand, each promoted when it
     is faster; bf16 only at Number Wrong 0 and RelL2 < 1e-6 against the
     f32 oracle;
  2. on the natural order, when tpu_plan picks DIA there, the DIA and
     DIA+bf16 candidates, promoted on the same terms;
  3. the baselines (kernels/segsum, bcoo, dense), library calls on the
     RCM'd matrix: vs_baseline is the flagship's speed over the fastest
     of those that run (dense is over its cap past 8,192 x 8,192 and
     says so).

Every time is warm TimeMin from a CUDA graph (bench/harness.bench_spmv;
a baseline the graph cannot capture is timed eagerly and labelled so).
The warm regime reuses one operator, which may sit in the 50 MB L2
(lap2d_1024's DIA operator is 21 MB in f32, 10.5 MB in bf16), so the
flagship is also timed cold (bench_spmv_cold: operator copies of >= 4x
L2 in rotation) on a stderr line of its own. stderr carries a `#` line
per candidate, the baselines and both regimes; stdout ends with
bench.py's one JSON line: metric spmv_gflops, value (warm GF/s),
unit, vs_baseline.

`--device cpu` builds and validates every candidate and baseline with
the plain versions (use a small TPU_SPMV_BENCH_N) and prints neither a
time nor the JSON line: a CPU time is not the card's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

BENCH_N = 1024
# bench.py's promotion bar for bf16 values against the f32 oracle.
BF16_PROMOTE_REL = 1e-6


@dataclasses.dataclass
class Entry:
    """One candidate or baseline: its call, operands and check."""

    name: str
    fn: object
    layout: object
    x: torch.Tensor
    nnz: int
    wrong: int
    rel: float
    res: object = None  # warm BenchResult on the card


def _note(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def _check(name, fn, layout, x, oracle, nnz) -> Entry:
    from tpu_spmv_torch.bench.harness import validate

    wrong, rel = validate(fn(layout, x).cpu().numpy(), oracle)
    return Entry(name, fn, layout, x, nnz, wrong, rel)


def _time(e: Entry) -> Entry:
    """Warm time from a CUDA graph, or eager where capture fails."""
    from tpu_spmv_torch.bench.harness import bench_spmv

    try:
        e.res = bench_spmv(e.fn, e.layout, e.x, nnz=e.nnz)
    except RuntimeError as err:
        torch.cuda.synchronize()
        _note(f"{e.name}: no CUDA-graph capture ({err}); timed eagerly")
        e.res = bench_spmv(e.fn, e.layout, e.x, nnz=e.nnz, graph=False)
    return e


def _gf(e: Entry) -> str:
    return (f"{e.res.gflops:.1f} GFLOP/s ({e.res.time_min * 1e6:.2f} us, "
            f"{e.res.launch})")


def _pad(e: Entry) -> float:
    pad = getattr(e.layout, "padding_ratio", None)
    return pad if pad is not None else e.layout.vals.numel() / e.nnz


def _promote(flag: Entry, cand: Entry, exact: bool, timed: bool) -> Entry:
    """cand in place of flag when it validates (exact: also RelL2 <
    BF16_PROMOTE_REL against the f32 oracle) and, on the card, is
    faster. Only a candidate that validates is timed."""
    ok = cand.wrong == 0 and (not exact or cand.rel < BF16_PROMOTE_REL)
    if not (timed and ok):
        _note(f"{cand.name} candidate: Number Wrong {cand.wrong}, RelL2 "
              f"{cand.rel:.2e}, pad {_pad(cand):.2f} ("
              + ("not promoted" if timed else
                 "plain version on the CPU: no time") + ")")
        return flag
    _time(cand)
    _note(f"{cand.name} candidate: {_gf(cand)} wrong={cand.wrong} "
          f"relL2={cand.rel:.1e} pad={_pad(cand):.2f} "
          f"(vs {flag.res.gflops:.1f} {flag.name})")
    return cand if cand.res.time_min < flag.res.time_min else flag


def run(n_grid: int, device) -> dict:
    """bench.py's sequence at grid side n_grid on `device`. Returns
    {"checked": [(name, wrong, rel), ...] of every candidate and
    baseline, "flagship": its name, "json": bench.py's line (None on the
    CPU)}."""
    from tpu_spmv_torch.bench.harness import (
        bench_spmv_cold, roofline_nnzs,
    )
    from tpu_spmv_torch.bench.matrices import laplacian_2d
    from tpu_spmv_torch.formats.dia import DiaSlabs
    from tpu_spmv_torch.formats.packed import PackedRanked
    from tpu_spmv_torch.formats.sell import RankedSlabs, SellSlabs
    from tpu_spmv_torch.hw import device_spec
    from tpu_spmv_torch.kernels.bcoo import BCOOLayout, spmv_bcoo
    from tpu_spmv_torch.kernels.dense import DenseLayout, spmv_dense
    from tpu_spmv_torch.kernels.dia import spmv_dia
    from tpu_spmv_torch.kernels.packed import spmv_packed
    from tpu_spmv_torch.kernels.segsum import SegsumLayout, spmv_segsum
    from tpu_spmv_torch.kernels.sell import spmv_ranked, spmv_sell
    from tpu_spmv_torch.reorder import rcm
    from tpu_spmv_torch.tune.model import tpu_plan

    device = torch.device(device)
    timed = device.type == "cuda"
    bf16 = torch.bfloat16
    mat_raw = laplacian_2d(n_grid)
    mat = mat_raw.permuted(rcm(mat_raw.indptr, mat_raw.indices))
    nnz = mat.nnz
    x_np = np.random.default_rng(0).standard_normal(mat.n).astype(np.float32)
    x = torch.from_numpy(x_np).to(device)
    oracle = mat.matvec(x_np)
    checked = []

    def check(name, fn, layout, xt=x, y_ref=oracle):
        e = _check(name, fn, layout.to(device), xt, y_ref, nnz)
        checked.append((e.name, e.wrong, e.rel))
        return e

    plan = tpu_plan(mat, assume_rcm=True)
    builds = {
        "packed": (spmv_packed, lambda vdt=None: PackedRanked.from_csr(
            mat, val_dtype=vdt, bin_blocks=max(plan.bin_blocks, 0))),
        "ranked": (spmv_ranked, lambda vdt=None: RankedSlabs.from_csr(
            mat, bin_blocks=plan.bin_blocks, val_dtype=vdt)),
    }
    kernel = plan.kernel if plan.kernel in builds else "sell"
    try:
        if kernel == "sell":
            raise ValueError(f"the plan is {plan.kernel}")
        fn, build = builds[kernel]
        flag = check(kernel, fn, build())
    except ValueError as err:
        _note(f"{kernel} layout unavailable ({err}); sell")
        kernel = "sell"
        flag = check(kernel, spmv_sell, SellSlabs.from_csr(mat))
    _note(f"plan: {plan.kernel} ({plan.reason})")
    if timed:
        _time(flag)

    if kernel != "packed":
        try:
            flag = _promote(flag, check("packed", spmv_packed,
                                        builds["packed"][1]()), False, timed)
        except ValueError as err:
            _note(f"packed candidate unavailable: {err!r}")
    if flag.name in builds:
        fn, build = builds[flag.name]
        flag = _promote(flag, check(f"{flag.name}+bf16", fn, build(bf16)),
                        True, timed)

    plan_raw = tpu_plan(mat_raw, assume_rcm=False)
    if plan_raw.kernel == "dia":
        x_raw_np = np.random.default_rng(2).standard_normal(
            mat_raw.n).astype(np.float32)
        x_raw = torch.from_numpy(x_raw_np).to(device)
        y_raw = mat_raw.matvec(x_raw_np)
        for name, vdt in (("dia", None), ("dia+bf16", bf16)):
            flag = _promote(flag, check(name, spmv_dia, DiaSlabs.from_csr(
                mat_raw, val_dtype=vdt), x_raw, y_raw), vdt is not None, timed)
    else:
        _note(f"no DIA candidate: natural order plans {plan_raw.kernel}")

    bases = [check("segsum", spmv_segsum,
                   SegsumLayout.from_csr(mat, device=device)),
             check("bcoo", spmv_bcoo, BCOOLayout.from_csr(mat, device=device))]
    try:
        bases.append(check("dense", spmv_dense,
                           DenseLayout.from_csr(mat, device=device)))
        dense_txt = ""
    except ValueError as err:
        dense_txt = f", dense not run ({err})"
    bad = [c for c in checked if c[1] != 0]
    if not timed:
        _note("baselines: " + ", ".join(
            f"{b.name} Number Wrong {b.wrong}, RelL2 {b.rel:.2e}"
            for b in bases) + dense_txt + " (plain on the CPU: no time)")
        return dict(checked=checked, flagship=flag.name, json=None)
    if bad:
        raise SystemExit(f"validation failed: {bad}")

    base = min((_time(b) for b in bases), key=lambda b: b.res.time_min)
    _note("baselines (warm TimeMin): " + ", ".join(
        f"{b.name} {_gf(b)}" for b in bases) + dense_txt
        + f" | baseline: {base.name}")
    lay = flag.layout
    roof = roofline_nnzs(lay.hbm_bytes / nnz)
    _note(f"flagship [{flag.name}] warm: {_gf(flag)}, "
          f"{flag.res.vals_per_s / 1e9:.2f} Gnnz/s, "
          f"{100 * flag.res.vals_per_s / roof:.0f}% of the layout roofline "
          f"(the operator may sit in the L2) | baseline {base.name}: "
          f"{base.res.gflops:.2f} GFLOP/s | wrong={flag.wrong} "
          f"relL2={flag.rel:.1e} pad={_pad(flag):.2f}")
    bw = device_spec(device).hbm_bytes_per_s
    cold = bench_spmv_cold(flag.fn, lay.clone, flag.x, nnz=nnz,
                           layout_bytes=lay.nbytes)
    _note(f"flagship [{flag.name}] cold (operator streamed from HBM, "
          f"K={cold.iters[2]} copies of {lay.nbytes / 2**20:.1f} MB): "
          f"TimeMin/TimeAvg {cold.time_min * 1e6:.2f}/"
          f"{cold.time_avg * 1e6:.2f} us, {cold.gflops:.1f} GFLOP/s, "
          f"operator bytes at {100 * lay.nbytes / cold.time_avg / bw:.0f}% "
          f"of {bw / 1e12:.2f} TB/s (TimeAvg)")
    line = {
        "metric": "spmv_gflops",
        "value": round(flag.res.gflops, 2),
        "unit": "GFLOP/s",
        "vs_baseline": round(base.res.time_min / flag.res.time_min, 2),
    }
    return dict(checked=checked, flagship=flag.name, json=line)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the flagship is timed on the card "
                         "(--device cpu validates only)")
    report = run(int(os.environ.get("TPU_SPMV_BENCH_N", BENCH_N)),
                 args.device)
    if report["json"] is not None:
        print(json.dumps(report["json"]), flush=True)
    return 0 if all(w == 0 for _, w, _ in report["checked"]) else 1


if __name__ == "__main__":
    raise SystemExit(main())
