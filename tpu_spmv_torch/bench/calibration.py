"""The planner's calibration on the card at several sample scales, and
how each fit ranks the kernels it chooses between.

    python -m tpu_spmv_torch.bench.calibration [--scales 8 16]
        [--matrices lap2d_1024:always banded_1m:auto] [--device cuda|cpu]

For each scale it runs the protocol of tools.tune (measure_points: the
sell sweep over spans, the binned ranked points, packed against ranked,
ragged against uniform, DIA, the read rate and the solve chains) and
prints the points and the fit, beside the shipped entry
for this card (data/calib.json) and the module defaults. Then, on each
matrix (NAME:RCM, RCM as tools.spmv's --rcm), it times spmv_sell,
spmv_ranked and spmv_packed on the layouts the planner weighs (aligned
slots; warm TimeMin, CUDA graph) and, under each set of constants, prints
the planner's cost of those three candidates, whether their order by
cost is their order by time, and the plan (tune/model.tpu_plan). Last, a
JSON line: the fits by scale. A scale at which the samples take only a
few microseconds measures launch overhead more than the kernels: the
lines of each scale give the sample times.

`--device cpu` runs the plain versions timed on the host clock (a check
of the script, not a card's numbers); pass small matrices and scales.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile

import numpy as np
import torch


def calibrate(scales, device) -> dict:
    """{scale: (points, fit)} of tools.tune's protocol at each scale."""
    from tpu_spmv_torch.tools import tune

    out = {}
    for scale in scales:
        print(f"== calibration at scale {scale}", flush=True)
        points = tune.measure_points(scale, device, log=sys.stdout)
        out[scale] = (points, tune.fit(points))
        print(f"fit at scale {scale}: {json.dumps(out[scale][1])}",
              flush=True)
    return out


@contextlib.contextmanager
def pinned(entry: dict):
    """Within the block, `entry` is the current card's calibration (a
    table of its own named by $TPU_SPMV_TORCH_CALIB)."""
    from tpu_spmv_torch import hw

    old = os.environ.get(hw.CALIB_ENV)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "calib.json")
        with open(path, "w") as f:
            json.dump({hw.device_kind(): entry}, f)
        os.environ[hw.CALIB_ENV] = path
        try:
            yield
        finally:
            if old is None:
                del os.environ[hw.CALIB_ENV]
            else:
                os.environ[hw.CALIB_ENV] = old


def _plan_under(entry: dict, mat, assume_rcm: bool):
    """(plan, {kernel: cost} of the aligned sell/ranked/packed
    candidates) with `entry` as the current card's constants."""
    from tpu_spmv_torch.tune.model import tpu_plan

    cands = []
    with pinned(entry):
        plan = tpu_plan(mat, assume_rcm=assume_rcm, candidates=cands)
    costs = {k: c for c, k, w, _, _ in cands
             if w == 0 and k in ("sell", "ranked", "packed")}
    return plan, costs


def rank_check(specs, entries: dict, device) -> list:
    """For each NAME:RCM, the three kernels' warm times and, under each
    named set of constants, their planned costs and the plan. Returns
    [(matrix, {kernel: seconds}, {entry: (plan kernel, W, order ok)})]."""
    from tpu_spmv_torch.formats.packed import PackedRanked
    from tpu_spmv_torch.formats.sell import RankedSlabs, SellSlabs
    from tpu_spmv_torch.kernels.packed import spmv_packed
    from tpu_spmv_torch.kernels.sell import spmv_ranked, spmv_sell
    from tpu_spmv_torch.tools.spmv import load_input, prepare
    from tpu_spmv_torch.tools.tune import _seconds

    rows = []
    for spec in specs:
        name, rcm = spec.split(":")
        mat = load_input(f"synthetic:{name}")
        ck, _ = prepare(mat, rcm)
        m = ck.matrix
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(
            m.n).astype(np.float32)).to(device)
        times = {}
        for kernel, fn, build in (
                ("sell", spmv_sell, SellSlabs.from_csr),
                ("ranked", spmv_ranked, RankedSlabs.from_csr),
                ("packed", spmv_packed, PackedRanked.from_csr)):
            lay = build(m).to(device)
            times[kernel] = _seconds(fn, lay, x)
            del lay
        measured = sorted(times, key=times.get)
        print(f"{spec}: warm " + ", ".join(
            f"{k} {times[k] * 1e6:.2f} us" for k in measured), flush=True)
        verdicts = {}
        for label, entry in entries.items():
            plan, costs = _plan_under(entry, m, rcm == "always")
            order = sorted(costs, key=costs.get)
            ok = order == [k for k in measured if k in costs]
            verdicts[label] = (plan.kernel, plan.bin_blocks, ok)
            print(f"  {label}: costs " + ", ".join(
                f"{k} {costs[k]:.0f}" for k in order)
                + f"; order {'matches' if ok else 'differs from'} the "
                f"times; plan {plan.kernel} W={plan.bin_blocks} "
                f"sigma={plan.sigma} ({plan.reason})", flush=True)
        rows.append((spec, times, verdicts))
    return rows


def shipped_entry() -> dict:
    """The shipped table's entry for the current card, {} without one."""
    from tpu_spmv_torch import hw

    try:
        with open(hw.SHIPPED_CALIB) as f:
            return json.load(f).get(hw.device_kind(), {})
    except (OSError, ValueError):
        return {}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scales", type=float, nargs="+", default=[8.0, 16.0])
    ap.add_argument("--matrices", nargs="+",
                    default=["lap2d_1024:always", "banded_1m:auto"])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device (use --device cpu for a check "
                             "of the script)")
        from tpu_spmv_torch import hw

        print(f"nvidia-smi: {hw.nvidia_smi()}", flush=True)
    fits = calibrate(args.scales, device)
    shipped = shipped_entry()
    print(f"shipped entry: {json.dumps(shipped) if shipped else 'none'}")
    entries = {f"fit at scale {s}": f for s, (_, f) in fits.items()}
    entries.update({"shipped": shipped, "module defaults": {}})
    rank_check(args.matrices, entries, device)
    print(json.dumps({str(s): f for s, (_, f) in fits.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
