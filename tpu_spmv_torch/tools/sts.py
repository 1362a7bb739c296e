"""Sparse-triangular-solve CLI of the port: build the pack schedule,
solve L x = b on a CUDA card, validate against x = ones, time the solve.

Counterpart of `python -m tpu_spmv.tools.sts`, with its flags and output
(`packs: ...`, `Total Error:`, `Number Wrong:`, then TimeMin/TimeMax/
TimeAvg/GFLOPs with nnz = the lower factor's nonzeros). Timing runs on
the card with CUDA events (bench/harness.py, warm regime: the layout is
reused every call). `--device cpu` runs the plain PyTorch versions and
is accepted only with `--validate-only`.

Usage:
  python -m tpu_spmv_torch.tools.sts matrix.mtx|synthetic:NAME [num_runs]
      [--order LS|COLOR] [--part lower|upper] [--k 2|3|4] [--sizes 8 ...]
      [--tol 0.01] [--validate-only] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from tpu_spmv_torch.tools.spmv import load_input

# The JAX CLI's distributed solve runs over dist/, not ported yet.
REFUSED_DEVICES = "A13 (distributed layer)"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", help=".csr/.csr3/.mtx file, or synthetic:<name>")
    ap.add_argument("num_runs", nargs="?", type=int, default=20,
                    help="timed samples (each of enough back-to-back "
                    "solves to last ~20 ms)")
    ap.add_argument("--order", default="LS", choices=("LS", "COLOR"))
    ap.add_argument("--part", default="lower", choices=("lower", "upper"),
                    help="triangle to solve; 'upper' runs the backward "
                    "substitution by reversing rows and columns")
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--sizes", type=int, nargs="*", default=None)
    ap.add_argument("--tol", type=float, default=0.01)
    ap.add_argument("--devices", type=int, default=1,
                    help="one device only (more is refused)")
    ap.add_argument("--validate-only", action="store_true",
                    help="skip the timed benchmark")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu runs the plain PyTorch versions and needs "
                    "--validate-only")
    args = ap.parse_args(argv)

    if args.devices > 1:
        raise SystemExit(
            "--devices > 1 (the distributed block back-substitution) is not "
            f"ported to the GPU yet (ROADMAP.md item {REFUSED_DEVICES})"
        )
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

    from tpu_spmv_torch.sts.host import (
        build_sts, check_error, compute_b, reversed_for_upper,
    )
    from tpu_spmv_torch.sts.solve import LowerSolveLayout, lower_solve

    mat = load_input(args.input)
    if args.part == "upper":
        mat, _rev = reversed_for_upper(mat)
        print("upper solve: rows+columns reversed (backward substitution)")
    sizes = tuple(args.sizes) if args.sizes else tuple([32] * max(args.k - 2, 0))
    sys_ = build_sts(mat, order_type=args.order, k=args.k, sup_row_sizes=sizes)
    print(
        f"packs: {sys_.num_packs}  pack sizes: min {int(sys_.pack_sizes().min())} "
        f"max {int(sys_.pack_sizes().max())} avg {float(sys_.pack_sizes().mean()):.1f}"
    )

    b = compute_b(sys_.lower)  # x_exact = ones
    layout = LowerSolveLayout.build(sys_, b)
    kind = layout.kernel
    detail = (f"rank_nb {layout.ranked.rank_nb}" if layout.ranked is not None
              else f"max_nb {layout.slabs.max_nb}")
    print(f"solve kernel: {kind} ({layout.slabs.num_chunks} chunks, {detail})")
    layout = layout.to(device)

    x = lower_solve(layout).cpu().numpy()
    num_wrong = int(np.sum(np.abs(x - 1.0) > args.tol))
    print(f"Total Error: {check_error(x):g}")
    print(f"Number Wrong: {num_wrong}")
    if args.validate_only:
        return 0 if num_wrong == 0 else 1

    from tpu_spmv_torch.bench.harness import bench_spmv

    def solve(lay, b_flat):
        return lower_solve(lay, b_scale=b_flat.view(-1, 128))

    res = bench_spmv(solve, layout, layout.b_scale.reshape(-1),
                     samples=max(args.num_runs, 1), nnz=sys_.lower.nnz)
    print("warm regime: one layout reused every solve (CUDA graph, "
          "device time)")
    print(res.summary(), end="")
    return 0 if num_wrong == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
