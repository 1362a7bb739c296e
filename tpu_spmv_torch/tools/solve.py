"""Iterative-solver CLI of the port: CG, Jacobi-PCG and IC(0)-PCG over
the row-sharded SpMV on CUDA cards.

Counterpart of `python -m tpu_spmv.tools.solve`, with its flags and
printed lines: A x = b (b = ones) by a fixed number of iterations,
validated by the RMS residual on the host, exit 0 when it is below
--tol. Plain CG and Jacobi-PCG (--pcg / --precond jacobi) run over
dist.ShardedRanked (dist.OverlapRanked with --overlap, which falls back
to the exchange-then-compute path when the banded halo does not apply)
on D shards, printing `devices=D halo=H rows/shard=R`; --precond ic0 on
one device runs IC(0)-PCG (`ic0: rows=... breakdowns=...`), and
--precond ic0-bj on one device is exact IC(0), as the reference routes
it. On D > 1 devices, --precond ic0 runs exact IC(0) by two block
forward substitutions an application (sts/ic0.ShardedIC0Preconditioner,
`ic0 (distributed, D=...)`) and ic0-bj block-Jacobi IC(0), one factor a
shard (BlockJacobiIC0Preconditioner, `ic0-bj (block-Jacobi, D=...)`),
both in PCG over ShardedRanked (`ic0_sharded`, which chip_smoke.py
drives with D shards on one card). --pcg and --overlap do not apply to
IC(0) and are ignored with the reference's message.

--devices counts CUDA cards (0: all of them; more than the machine has
is refused). On the card the iterations replay a CUDA graph of one
iteration when the shards share one card (the counterpart of the JAX
loop's jit), and the line `graph: ... us per iteration` follows.
`--device cpu` runs the plain PyTorch versions eagerly with the D
shards on the CPU (0: one shard).

Usage:
  python -m tpu_spmv_torch.tools.solve matrix.mtx|synthetic:NAME
      [--iters 100] [--pcg] [--precond jacobi|ic0|ic0-bj] [--devices N]
      [--overlap] [--rcm auto|always|never] [--tol 1e-4]
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from tpu_spmv_torch import obs
from tpu_spmv_torch.tools.spmv import load_input


def mesh_devices(requested: int, device: torch.device) -> list:
    """The devices of a D-shard mesh as --devices asks for them: cards
    0..D-1 on cuda (0: every card; more than the machine has raises
    SystemExit with the reference's message), D shards on the CPU (0:
    one)."""
    if device.type == "cpu":
        return [device] * max(requested, 1)
    avail = torch.cuda.device_count()
    D = requested or avail
    if D > avail:
        raise SystemExit(f"requested {D} devices, only {avail} available")
    return [torch.device("cuda", i) for i in range(D)]


def _ic0(mat, args, device) -> int:
    """IC(0)-PCG on one device (tpu_spmv/tools/solve.py's D = 1 path)."""
    from tpu_spmv_torch.formats.sell import RankedSlabs
    from tpu_spmv_torch.sts.ic0 import (
        IC0Preconditioner, capture_pcg_step, pcg_ic0_init, pcg_ic0_solve,
    )

    b_host = np.ones(mat.m, np.float32)
    since = obs.mark()
    lay = RankedSlabs.from_csr(mat).to(device)
    pre = IC0Preconditioner.build(mat, device=device)
    print(f"ic0: rows={pre.lay_l.m} breakdowns={pre.breakdowns}")
    print(f"ic0 solves: L {pre.lay_l.kernel} ({pre.lay_l.num_packs} packs), "
          f"L^T {pre.lay_u.kernel} ({pre.lay_u.num_packs} packs); host "
          f"set-up {obs.phase_seconds(since):.2f}s")
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
    return _report(mat, sol, rz, args.iters, args.tol,
                   time.perf_counter() - t0, device.type == "cuda")


def ic0_sharded(mat, precond: str, devices, iters: int, tol: float) -> int:
    """IC(0)-PCG over len(devices) shards (tpu_spmv/tools/solve.py's
    D > 1 path): precond "ic0" (exact, distributed) or "ic0-bj"
    (block-Jacobi). Prints the reference's lines, and on one card the
    us of a captured iteration; returns the exit code."""
    from tpu_spmv_torch.dist.sharding import (
        ShardedRanked, gather_vector, make_row_mesh, shard_vector,
    )
    from tpu_spmv_torch.sts.ic0 import (
        BlockJacobiIC0Preconditioner, ShardedIC0Preconditioner,
        capture_pcg_sharded_step, pcg_ic0_sharded, pcg_ic0_sharded_init,
    )

    mesh = make_row_mesh(devices)
    D = mesh.size
    lay = ShardedRanked.build(mat, D).device_put(mesh)
    if precond == "ic0-bj":
        cls, kind = BlockJacobiIC0Preconditioner, "ic0-bj (block-Jacobi"
    else:
        cls, kind = ShardedIC0Preconditioner, "ic0 (distributed"
    pre = cls.build(mat, D, lay.padded_m).device_put(mesh)
    print(f"{kind}, D={D}): rows={mat.m} breakdowns={pre.breakdowns}")
    b = shard_vector(np.ones(mat.m, np.float32), mesh, lay.padded_m)
    t0 = time.perf_counter()
    sol, rz = pcg_ic0_sharded(lay, b, pre, mesh, iters=iters)
    sol = gather_vector(sol)[: mat.m]
    graph = _one_card(mesh.devices)
    rc = _report(mat, sol, rz, iters, tol, time.perf_counter() - t0, graph)
    if graph:
        state = pcg_ic0_sharded_init(b, pre, mesh)
        us = _time_graph(capture_pcg_sharded_step(lay, pre, mesh, state))
        print(f"graph: {us:.2f} us per iteration ({precond}-PCG, D={D})")
    return rc


def _one_card(devices) -> bool:
    """Whether every shard lies on one CUDA card (the iterations then
    replay a captured CUDA graph)."""
    return len(set(devices)) == 1 and devices[0].type == "cuda"


def _report(mat, sol, rz, iters, tol, dt, graph: bool) -> int:
    resid = float(np.linalg.norm(mat.matvec(sol) - 1.0) / np.sqrt(mat.m))
    print(f"iters={iters} rms_residual={resid:.3e} "
          f"device_rz={float(rz):.3e} wall={dt:.2f}s"
          + (" (incl. graph capture)" if graph else ""))
    return 0 if resid < tol else 1


def _time_iteration(lay, mesh, b, inv) -> float:
    """Microseconds of one replay of a captured CG or Jacobi-PCG
    iteration, on a state of its own (_time_graph)."""
    from tpu_spmv_torch.dist.solvers import capture_step, cg_init, pcg_init

    state = cg_init(b, mesh) if inv is None else pcg_init(b, mesh, inv)
    return _time_graph(capture_step(lay, mesh, state, inv))


def _time_graph(graph) -> float:
    """Microseconds of one replay of a captured iteration (CUDA events
    over 20 replays, after one)."""
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        graph.replay()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / 20 * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", help=".csr/.csr3/.mtx file, or synthetic:<name>")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--pcg", action="store_true",
                    help="Jacobi (diagonal) preconditioning")
    ap.add_argument("--precond", default=None,
                    choices=("jacobi", "ic0", "ic0-bj"),
                    help="jacobi (= --pcg); ic0: incomplete Cholesky, M^-1 "
                    "applied by two triangular solves per iteration (on "
                    "D > 1 devices, two block forward substitutions); "
                    "ic0-bj: block-Jacobi IC(0), one factor a shard, no "
                    "communication (exact IC(0) on one device)")
    ap.add_argument("--devices", type=int, default=0,
                    help="shards: CUDA cards (0 = all), or shards on the "
                    "CPU with --device cpu (0 = one)")
    ap.add_argument("--rcm", default="auto", choices=("auto", "always", "never"))
    ap.add_argument("--tol", type=float, default=1e-4,
                    help="RMS residual bound for exit status")
    ap.add_argument("--overlap", action="store_true",
                    help="the overlapped layout (OverlapRanked: the halo "
                    "copies run behind the main kernel); falls back to the "
                    "exchange-then-compute path when the banded halo does "
                    "not apply")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu runs the plain PyTorch versions")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "no CUDA device: the port runs on a CUDA card (use --device cpu "
            "for a CPU check)"
        )
    devices = mesh_devices(args.devices, device)
    D = len(devices)

    from tpu_spmv_torch.tune.model import tpu_plan

    mat = load_input(args.input)
    if mat.m != mat.n:
        raise SystemExit("CG needs a square (SPD) matrix")
    if args.rcm != "never":
        if args.rcm == "always" or tpu_plan(mat).needs_rcm:
            from tpu_spmv_torch.reorder import rcm as rcm_fn

            mat = mat.permuted(rcm_fn(mat.indptr, mat.indices))
            print("RCM applied")

    if args.precond == "jacobi":
        args.pcg = True
    if args.precond in ("ic0", "ic0-bj"):
        if args.overlap or args.pcg:
            print("(--overlap/--pcg do not apply to --precond ic0; "
                  "ignored)")
        if D > 1:
            return ic0_sharded(mat, args.precond, devices, args.iters,
                               args.tol)
        if args.precond == "ic0-bj":
            # One shard: its block is the whole matrix, so block-Jacobi
            # IC(0) is exact IC(0).
            print("ic0-bj with --devices 1 == exact ic0; "
                  "using single-chip ic0 path")
        return _ic0(mat, args, device)

    from tpu_spmv_torch.dist.sharding import (
        OverlapRanked, ShardedRanked, gather_vector, make_row_mesh,
        shard_vector,
    )
    from tpu_spmv_torch.dist.solvers import (
        cg_solve, jacobi_inv_diag, pcg_solve,
    )

    mesh = make_row_mesh(devices)
    lay = None
    if args.overlap and D > 1:
        try:
            lay = OverlapRanked.build(mat, D)
            print(f"overlap split: edge nnz = {lay.edge.nnz} "
                  f"({100 * lay.edge.nnz / max(mat.nnz, 1):.1f}% waits "
                  "on the exchange)")
        except ValueError as e:
            print(f"overlap unavailable ({e}); using spmv_sharded")
    if lay is None:
        lay = ShardedRanked.build(mat, D)
    lay = lay.device_put(mesh)
    print(f"devices={D} halo={lay.halo} rows/shard={lay.padded_m // D}")

    b = shard_vector(np.ones(mat.m, np.float32), mesh, lay.padded_m)
    inv = None
    if args.pcg:
        inv = shard_vector(jacobi_inv_diag(mat.diagonal(), lay.padded_m),
                           mesh)
    t0 = time.perf_counter()
    if inv is None:
        sol, rz = cg_solve(lay, b, mesh, iters=args.iters)
    else:
        sol, rz = pcg_solve(lay, b, mesh, inv, iters=args.iters)
    sol = gather_vector(sol)[: mat.m]
    rc = _report(mat, sol, rz, args.iters, args.tol,
                 time.perf_counter() - t0, _one_card(devices))
    if _one_card(devices):
        print(f"graph: {_time_iteration(lay, mesh, b, inv):.2f} us per "
              f"iteration ({'Jacobi-PCG' if args.pcg else 'CG'}, D={D})")
    return rc


if __name__ == "__main__":
    sys.exit(main())
