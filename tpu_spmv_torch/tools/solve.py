"""Iterative-solver CLI of the port: IC(0)-preconditioned CG on one CUDA
card.

Counterpart of `python -m tpu_spmv.tools.solve --precond ic0` on one
device: A x = b (b = ones) by a fixed number of PCG iterations, each one
`spmv_ranked` and two chunk-ordered triangular solves, validated by the
RMS residual on the host; it prints the same `ic0: rows=...
breakdowns=...` and `iters=... rms_residual=...` lines and exits 0 when
the residual is below --tol. On the card the loop runs from a CUDA graph
of one iteration (the counterpart of the JAX loop's jit); `--device cpu`
runs the plain PyTorch versions eagerly.

Everything else the JAX CLI runs goes over its distributed layer and is
refused, naming ROADMAP.md item A13: plain CG, --pcg / --precond jacobi,
--precond ic0-bj, --overlap, and --devices other than 0 or 1.

Usage:
  python -m tpu_spmv_torch.tools.solve matrix.mtx|synthetic:NAME
      --precond ic0 [--iters 100] [--rcm auto|always|never] [--tol 1e-4]
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from tpu_spmv_torch.tools.spmv import load_input

REFUSED = "A13 (distributed layer)"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", help=".csr/.csr3/.mtx file, or synthetic:<name>")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--pcg", action="store_true",
                    help="Jacobi preconditioning (not ported: refused)")
    ap.add_argument("--precond", default=None,
                    choices=("jacobi", "ic0", "ic0-bj"),
                    help="ic0: incomplete Cholesky, M^-1 applied by two "
                    "triangular solves per iteration (jacobi and ic0-bj "
                    "are refused)")
    ap.add_argument("--devices", type=int, default=0,
                    help="0 or 1: one device (more is refused)")
    ap.add_argument("--rcm", default="auto", choices=("auto", "always", "never"))
    ap.add_argument("--tol", type=float, default=1e-4,
                    help="RMS residual bound for exit status")
    ap.add_argument("--overlap", action="store_true",
                    help="not ported: refused")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu runs the plain PyTorch versions")
    args = ap.parse_args(argv)

    for refused, what in (
        (args.precond is None and not args.pcg, "plain CG (no --precond)"),
        (args.pcg or args.precond == "jacobi", "Jacobi PCG (--pcg)"),
        (args.precond == "ic0-bj", "--precond ic0-bj"),
        (args.overlap, "--overlap"),
        (args.devices not in (0, 1), f"--devices {args.devices}"),
    ):
        if refused:
            raise SystemExit(
                f"{what} runs over the distributed layer, not ported to "
                f"the GPU yet (ROADMAP.md item {REFUSED})"
            )
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "no CUDA device: the port runs on a CUDA card (use --device cpu "
            "for a CPU check)"
        )

    from tpu_spmv_torch.formats.sell import RankedSlabs
    from tpu_spmv_torch.sts.ic0 import (
        IC0Preconditioner, capture_pcg_step, pcg_ic0_init, pcg_ic0_solve,
    )
    from tpu_spmv_torch.tune.model import tpu_plan

    mat = load_input(args.input)
    if mat.m != mat.n:
        raise SystemExit("CG needs a square (SPD) matrix")
    if args.rcm != "never":
        if args.rcm == "always" or tpu_plan(mat).needs_rcm:
            from tpu_spmv_torch.reorder import rcm as rcm_fn

            mat = mat.permuted(rcm_fn(mat.indptr, mat.indices))
            print("RCM applied")

    b_host = np.ones(mat.m, np.float32)
    t0 = time.perf_counter()
    lay = RankedSlabs.from_csr(mat).to(device)
    pre = IC0Preconditioner.build(mat, device=device)
    print(f"ic0: rows={pre.lay_l.m} breakdowns={pre.breakdowns}")
    print(f"ic0 solves: L {pre.lay_l.kernel} ({pre.lay_l.num_packs} packs), "
          f"L^T {pre.lay_u.kernel} ({pre.lay_u.num_packs} packs); host "
          f"set-up {time.perf_counter() - t0:.2f}s")
    b = torch.from_numpy(b_host).to(device)

    t0 = time.perf_counter()
    if device.type == "cuda":
        state = pcg_ic0_init(b, pre)
        graph = capture_pcg_step(lay, pre, state)
        for _ in range(args.iters):
            graph.replay()
        sol, rz = state[0], state[3]
    else:
        sol, rz = pcg_ic0_solve(lay, b, pre, iters=args.iters)
    sol = sol.cpu().numpy()
    dt = time.perf_counter() - t0
    resid = float(np.linalg.norm(mat.matvec(sol) - b_host) / np.sqrt(mat.m))
    print(f"iters={args.iters} rms_residual={resid:.3e} "
          f"device_rz={float(rz):.3e} wall={dt:.2f}s"
          + (" (incl. graph capture)" if device.type == "cuda" else ""))
    return 0 if resid < args.tol else 1


if __name__ == "__main__":
    sys.exit(main())
