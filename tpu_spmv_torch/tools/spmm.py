"""SpMM benchmark CLI of the port: Y = A @ X with B right-hand sides on a
CUDA card.

Counterpart of `python -m tpu_spmv.tools.spmm` for one device, with its
flags and output keys: load, RCM, plan, build the packed or the ranked
layout, run the kernel, validate every column against the serial
oracle, time it (`TimeMin/TimeMax/TimeAvg`, `vals/s ... (% of
roofline) B=`, `Number Wrong:`, `RelL2:`). `--device cpu` runs the plain
PyTorch versions and is accepted only with `--validate-only`.

auto takes packed when the planner picks it and X (n x B floats) passes
the L2 residency gate, else the ranked layout, resident or windowed by
the same gate; `--kernel windowed` forces the windowed kernel (e.g.
`synthetic:lap2d_1024 --batch 8`, X 33.5 MB, is windowed under auto).
The windowed route cuts the window table at a smaller step and then
splits B into column passes until the ring of X blocks fits shared
memory.

--devices D other than 1 row-shards A over D shards and runs the
distributed SpMM (dist.spmm_sharded, each shard resident or windowed by
the residency gate on its own X window; --overlap takes dist.spmm_overlap,
resident only, and falls back to windowed spmm_sharded when the shard's X
is past the gate), validated against the serial oracle, printing
`devices=D halo=H rows/shard=R`. --devices counts CUDA cards (0: all of
them); with --device cpu it places D shards on the CPU (0: one).

Usage:
  python -m tpu_spmv_torch.tools.spmm matrix.mtx|synthetic:NAME [num_runs]
      [--batch B] [--kernel auto|resident|windowed]
      [--rcm auto|always|never] [--val-dtype f32|bf16] [--tol T]
      [--devices D] [--overlap] [--validate-only]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from tpu_spmv_torch.hw import target_device
from tpu_spmv_torch.tools.spmv import fit_window, load_input, x_budget

def build_spmm(mat, kernel: str, B: int, val_dtype=None, device=None):
    """(layout on `device`, spmm function, passes over the slabs), as
    tpu_spmv/tools/spmm.py:85-192 chooses them; device defaults to the
    card (hw.target_device). auto takes packed when the planner
    (tune/model.tpu_plan) picks it, the build succeeds and X passes the
    residency gate (resident_x_fits at batch=B); otherwise the ranked
    layout at the plan's bin width, with spmm_ranked when X passes the
    gate (or under resident) and spmm_ranked_windowed past it (or under
    windowed). The
    windowed route fits the ring to shared memory (tools/spmv.
    fit_window) and runs B/B' column passes when B' < B. A ranked build
    that fails ends the run: SpMM has no sell kernel."""
    from tpu_spmv_torch.formats.packed import PackedRanked
    from tpu_spmv_torch.formats.sell import RankedSlabs
    from tpu_spmv_torch.kernels.sell import resident_x_fits, window_bytes
    from tpu_spmv_torch.kernels.spmm import (
        spmm_packed, spmm_ranked, spmm_ranked_windowed,
    )
    from tpu_spmv_torch.tune.model import tpu_plan

    device = target_device(device)
    plan = tpu_plan(mat, assume_rcm=True)
    if kernel == "auto" and plan.kernel == "packed":
        try:
            layout = PackedRanked.from_csr(
                mat, bin_blocks=max(plan.bin_blocks, 0), val_dtype=val_dtype
            ).to(device)
        except ValueError as e:
            print(f"packed layout unavailable ({e}); falling back to ranked")
        else:
            if resident_x_fits(layout, batch=B):
                print(f"auto kernel: packed (plan; fill "
                      f"{layout.padding_ratio:.2f}, {plan.reason}; "
                      f"{x_budget(mat.n, device, B)})")
                return layout, spmm_packed, 1
            print(f"packed layout past the L2 residency budget "
                  f"({x_budget(mat.n, device, B)}; packed has no windowed "
                  "variant); taking the ranked layout")
    try:
        layout = RankedSlabs.from_csr(
            mat, bin_blocks=plan.bin_blocks, val_dtype=val_dtype
        ).to(device)
    except ValueError as e:
        raise SystemExit(
            f"ranked layout unavailable for this matrix ({e}); "
            "SpMM currently runs on the rank-windowed layout only"
        )
    if kernel == "auto":
        kernel = "resident" if resident_x_fits(layout, batch=B) else "windowed"
        print(f"auto kernel: {kernel} (ranked; {x_budget(mat.n, device, B)}; "
              f"plan {plan.kernel}: {plan.reason})")
    if kernel == "resident":
        return layout, spmm_ranked, 1
    try:
        layout, cols = fit_window(layout, B, device)
    except ValueError as e:
        raise SystemExit(
            f"no windowed SpMM path: {e}, even at one column per pass. "
            "Options: --kernel resident, or B columns of single-vector "
            "spmv_packed."
        )
    print(f"windowed SpMM: ring {layout.ring_blocks} blocks x {cols} "
          f"column(s) = {window_bytes(layout, cols) / 1024:.0f} KB of shared "
          f"memory, {layout.step_lo.numel()} steps of {layout.step_subtiles} "
          f"sub-tile(s), {-(-B // cols)} column pass(es) of B'={cols}")
    if cols == B:
        return layout, spmm_ranked_windowed, 1

    def column_passes(lay, X):
        return torch.cat([
            spmm_ranked_windowed(lay, X[:, i : i + cols].contiguous())
            for i in range(0, B, cols)
        ], dim=1)

    return layout, column_passes, -(-B // cols)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", help=".csr/.csr3/.mtx file, or synthetic:<name>")
    ap.add_argument("num_runs", nargs="?", type=int, default=20,
                    help="timed samples (each of enough back-to-back "
                    "launches to last ~20 ms)")
    ap.add_argument("--batch", type=int, default=8,
                    help="number of right-hand-side columns B")
    ap.add_argument(
        "--kernel", default="auto", choices=("auto", "resident", "windowed"),
        help="auto takes packed when the planner picks it and X passes the "
        "L2 residency gate, else ranked, resident or windowed by the gate; "
        "resident and windowed are ranked",
    )
    ap.add_argument("--rcm", default="auto", choices=("auto", "always", "never"))
    ap.add_argument("--tol", type=float, default=0.01)
    ap.add_argument("--val-dtype", default="f32", choices=("f32", "bf16"),
                    help="slab value storage; bf16 runs are validated "
                    "against the bf16-rounded operator")
    ap.add_argument("--devices", type=int, default=1,
                    help="other than 1: row-shard A and run the distributed "
                    "SpMM (dist.spmm_sharded) on D CUDA cards (0 = all), or "
                    "D shards on the CPU with --device cpu (0 = one)")
    ap.add_argument("--overlap", action="store_true",
                    help="with --devices: overlap the halo exchange behind "
                    "the main kernel (dist.OverlapRanked)")
    ap.add_argument("--validate-only", action="store_true",
                    help="skip the timed benchmark")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu runs the plain PyTorch versions and needs "
                    "--validate-only")
    args = ap.parse_args(argv)

    if args.batch < 1:
        raise SystemExit("--batch must be >= 1")
    device = torch.device(args.device)
    if device.type == "cpu" and not args.validate_only:
        raise SystemExit(
            "--device cpu runs only with --validate-only: timing needs a "
            "CUDA card"
        )
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "no CUDA device: the port runs on a CUDA card (use --device "
            "cpu --validate-only for a CPU check)"
        )

    from tpu_spmv_torch.bench.harness import validate
    from tpu_spmv_torch.tune.model import tpu_plan

    mat = load_input(args.input)
    if args.rcm != "never" and mat.m == mat.n:
        if args.rcm == "always" or tpu_plan(mat).needs_rcm:
            from tpu_spmv_torch.reorder import rcm as rcm_fn

            mat = mat.permuted(rcm_fn(mat.indptr, mat.indices))
            print("RCM applied")

    B = args.batch
    vdt = torch.bfloat16 if args.val_dtype == "bf16" else None
    if args.devices != 1:
        return _distributed(mat, args, B, vdt, device)
    layout, fn, passes = build_spmm(mat, args.kernel, B, vdt, device)
    X = np.random.default_rng(0).standard_normal((mat.n, B)).astype(np.float32)
    Xt = torch.from_numpy(X).to(device)
    Y = fn(layout, Xt).cpu().numpy()

    mat_v = mat
    if layout.vals.dtype == torch.bfloat16:
        mat_v = mat.rounded()
        print("(bf16 values: validated vs the bf16-rounded operator)")
    # Every column against its own serial oracle: the worst column's
    # RelL2, and the wrong entries summed over the columns.
    wrong, rel = 0, 0.0
    for b in range(B):
        w, r = validate(Y[:, b], mat_v.matvec(X[:, b]), tol=args.tol)
        wrong, rel = wrong + w, max(rel, r)
    if args.validate_only:
        print(f"Number Wrong: {wrong} ")
        print(f"RelL2: {rel:.3g}")
        return 0 if wrong == 0 else 1

    from tpu_spmv_torch.bench.harness import bench_spmv, roofline_vals
    from tpu_spmv_torch.hw import device_spec

    res = bench_spmv(fn, layout, Xt, samples=max(args.num_runs, 1),
                     nnz=mat.nnz)
    print("warm regime: one operator reused every launch (it may stay "
          f"in the {device_spec().l2_bytes / 2**20:.0f} MB L2)")
    print(res.summary(), end="")
    # A column-chunked windowed run streams the slabs once per pass, so
    # they amortize over B/passes columns (tpu_spmv/tools/spmm.py).
    roof = roofline_vals(layout.hbm_bytes * passes, mat.nnz, B)
    print(f"vals/s: {res.vals_per_s:.4g} "
          f"({100 * res.vals_per_s / roof:.0f}% of roofline) B={B}"
          + (f" in {passes} passes" if passes > 1 else ""))
    print(f"Number Wrong: {wrong} ")
    print(f"RelL2: {rel:.3g}")
    return 0 if wrong == 0 else 1


def _distributed(mat, args, B, vdt, device) -> int:
    """Row-sharded SpMM over D shards (tpu_spmv/tools/spmm.py's
    _distributed): spmm_overlap with --overlap when the banded halo
    applies and each shard's X window passes the residency gate, else
    spmm_sharded (per shard resident or windowed by the gate, unless
    --kernel names one), validated against the serial oracle."""
    import functools
    import types

    from tpu_spmv_torch.bench.harness import bench_spmv, validate
    from tpu_spmv_torch.dist.sharding import (
        OverlapRanked, ShardedRanked, gather_vector, make_row_mesh,
        shard_vector, spmm_overlap, spmm_sharded,
    )
    from tpu_spmv_torch.kernels.sell import resident_x_fits
    from tpu_spmv_torch.tools.solve import mesh_devices

    devices = mesh_devices(args.devices, device)
    D = len(devices)
    mesh = make_row_mesh(devices)
    lay = None
    if args.overlap and D > 1:
        try:
            lay = OverlapRanked.build(mat, D, val_dtype=vdt).device_put(mesh)
            # A shard stages its own rows and the 2H exchanged ones.
            staged = types.SimpleNamespace(
                n=lay.rows_per_shard + 2 * lay.halo,
                rank_nb=lay.main.rank_nb, vals=lay.main.shards[0].vals)
            if not resident_x_fits(staged, batch=B):
                print("staged X exceeds the residency budget; overlap is "
                      "resident-only — using windowed spmm_sharded")
                lay = None
            else:
                fn = functools.partial(spmm_overlap, mesh=mesh)
                print(f"overlap split: edge nnz = {lay.edge.nnz}")
        except ValueError as e:
            print(f"overlap unavailable ({e}); using spmm_sharded")
    if lay is None:
        lay = ShardedRanked.build(mat, D, val_dtype=vdt).device_put(mesh)
        fn = functools.partial(spmm_sharded, mesh=mesh, kernel=args.kernel)
        if args.kernel != "auto":
            print(f"per-shard kernel: {args.kernel}")
    print(f"devices={D} halo={lay.halo} rows/shard={lay.padded_m // D}")

    X = np.random.default_rng(0).standard_normal((mat.n, B)).astype(
        np.float32)
    Xs = shard_vector(X, mesh, lay.padded_m)
    Y = gather_vector(fn(lay, Xs))[: mat.m]
    mat_v = mat if vdt is None else mat.rounded()
    if vdt is not None:
        print("(bf16 values: validated vs the bf16-rounded operator)")
    Y_ref = np.stack([mat_v.matvec(X[:, b]) for b in range(B)], axis=1)
    wrong, rel = validate(Y, Y_ref, tol=args.tol)
    if not args.validate_only:
        # One CUDA graph cannot hold launches on several cards: a mesh
        # of cards is timed eagerly, by events on the first card's
        # stream, which every sharded call joins.
        res = bench_spmv(lambda lay_, _x: fn(lay_, Xs), lay, Xs[0],
                         samples=max(args.num_runs, 1), nnz=mat.nnz,
                         graph=len(set(devices)) == 1)
        print(res.summary(), end="")
        print(f"vals/s: {res.vals_per_s:.4g} B={B} D={D}")
    print(f"Number Wrong: {wrong} ")
    print(f"RelL2: {rel:.3g}")
    return 0 if wrong == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
