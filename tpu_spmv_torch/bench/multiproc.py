"""The distributed layer across processes: one process of a group, and
the launcher that starts the group.

    python -m tpu_spmv_torch.bench.multiproc --suite small --device cpu \\
        --out DIR

runs in one process of a group: its rank, the group's size and the
coordinator come from TPU_SPMV_PROCESS_ID, TPU_SPMV_NUM_PROCESSES and
TPU_SPMV_COORDINATOR, or from --process-id, --num-processes and
--coordinator, through dist/multihost.initialize (called twice: both
must return True). The process builds the suite's host layouts as every
other process does, places its own shards of D = SHARDS (4) on the
(hosts, rows) mesh (D / processes a process, all on --device; a card
without an index is card rank % count) and runs the suite's paths
(run_paths). It writes DIR/rank<r>.npz (its rows of each path's result,
"<path>/<d>" for each of its shards d) and DIR/rank<r>.json (what it
saw: the two initialize results, the backend, the mesh's shape, the
layouts' halo and edge nonzeros, each path's max |kernel - plain| over
its rows where asked, its eager us a call or an iteration, and with
NCCL the us a replay of a CUDA graph (a call, or a CG iteration
captured by dist/solvers.capture_step) or why capture failed; the kernels'
launches over the paths, counted from 0; whether the kernel library had
to be built), and prints "OK process <r>" last.

`spawn` starts such a group on this machine and waits for it within a
wall limit; the tests, chip_smoke.py and bench/dist_times.py start it
so. The same `run_paths` on a one-process mesh gives the one-process
result the group's rows are held to.

Suites (the matrices of bench/matrices.py, each x and b from a seed):
  small: tests/test_multiprocess.py's random_banded(2048 * 4, 60, 8,
    seed=0): spmv_sharded (halo and, halo="never", x gathered whole),
    cg_solve for 3 iterations (b = ones), spmm_sharded at B = 3,
    spmv_overlap; sts_solve_sharded on tests/test_dist_sts.py's
    random_banded(4000, 30, 6, seed=3) in COLOR order; exact and
    block-Jacobi pcg_ic0_sharded for 25 iterations (b = ones) on
    tests/test_ic0.py's random_banded(3000, 50, 8, seed=2) after RCM.
  full: lap2d_1024 after RCM (spmv_sharded, spmv_overlap, spmm_sharded
    at B = 8), cg_solve on lap3d_101 for --cg-iters, sts_solve_sharded
    on lap2d_1024 in level (LS) order (b for x = ones), exact and
    block-Jacobi IC(0)-PCG on lap3d_101 for --pcg-iters; each path
    against its plain version, one call (a preconditioner's apply).
  times: lap2d_1024 after RCM spmv_sharded and cg_solve on lap3d_101,
    timed only (bench/dist_times.py --procs).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import torch

# The layouts' random vectors.
X_SEED = 1
X_BATCH_SEED = 2
# Shards of every layout, hosts-major over the processes (D / processes
# a process), as tests/test_multiprocess.py shards its matrix.
SHARDS = 4


@dataclasses.dataclass
class Built:
    """A suite's host inputs and layouts, the same on every process."""

    suite: str
    spmv: object = None  # the SpMV matrix in the layouts' row order
    x: np.ndarray = None
    X: np.ndarray = None
    ranked: object = None  # ShardedRanked (halo)
    gathered: object = None  # ShardedRanked, halo="never"
    overlap: object = None
    cg: object = None  # the CG matrix
    cg_layout: object = None
    sts: object = None  # the TriangularSystem
    sts_layout: object = None
    sts_pad: np.ndarray = None
    sts_b: np.ndarray = None
    ic0: object = None  # the PCG matrix
    ic0_layout: object = None
    precond: dict = None  # {"ic0": ShardedIC0..., "ic0_bj": BlockJacobi...}
    seconds: float = 0.0


def build(suite: str) -> Built:
    """The suite's matrices, vectors and host layouts (not placed)."""
    from tpu_spmv_torch.dist.sharding import OverlapRanked, ShardedRanked
    from tpu_spmv_torch.dist.sts import ShardedLowerSolve
    from tpu_spmv_torch.sts import ic0
    from tpu_spmv_torch.sts.host import build_sts, compute_b
    from tpu_spmv_torch.tools.spmv import load_input, prepare

    t0 = time.perf_counter()
    out = Built(suite)
    if suite == "small":
        from tpu_spmv_torch.bench.matrices import random_banded
        from tpu_spmv_torch.reorder.rcm import rcm

        a = random_banded(2048 * SHARDS, 60, 8, seed=0)
        cg = a
        sts_mat, order = random_banded(4000, 30, 6, seed=3), "COLOR"
        pcg = random_banded(3000, 50, 8, seed=2)
        pcg = pcg.permuted(rcm(pcg.indptr, pcg.indices))
    else:
        a = prepare(load_input("synthetic:lap2d_1024"), "always")[0].matrix
        cg = load_input("synthetic:lap3d_101")
        sts_mat, order, pcg = load_input("synthetic:lap2d_1024"), "LS", cg
    out.spmv = a
    out.x = np.random.default_rng(X_SEED).standard_normal(a.n).astype(
        np.float32)
    out.ranked = ShardedRanked.build(a, SHARDS)
    out.cg = cg
    out.cg_layout = (out.ranked if cg is a
                     else ShardedRanked.build(cg, SHARDS))
    if suite == "times":
        out.seconds = time.perf_counter() - t0
        return out
    B = 3 if suite == "small" else 8
    out.X = np.random.default_rng(X_BATCH_SEED).standard_normal(
        (a.n, B)).astype(np.float32)
    out.overlap = OverlapRanked.build(a, SHARDS)
    if suite == "small":
        out.gathered = ShardedRanked.build(a, SHARDS, halo="never")
    out.sts = build_sts(sts_mat, order_type=order)
    out.sts_b = (np.random.default_rng(1).standard_normal(
        out.sts.lower.m).astype(np.float32) if suite == "small"
        else compute_b(out.sts.lower))
    out.sts_layout, out.sts_pad = ShardedLowerSolve.build(
        out.sts, out.sts_b, SHARDS)
    out.ic0 = pcg
    out.ic0_layout = (out.cg_layout if pcg is cg
                      else ShardedRanked.build(pcg, SHARDS))
    out.precond = {
        name: cls.build(pcg, SHARDS, out.ic0_layout.padded_m)
        for name, cls in (("ic0", ic0.ShardedIC0Preconditioner),
                          ("ic0_bj", ic0.BlockJacobiIC0Preconditioner))}
    out.seconds = time.perf_counter() - t0
    return out


def _sync(mesh) -> None:
    for d in mesh.local:
        if mesh.devices[d].type == "cuda":
            torch.cuda.synchronize(mesh.devices[d])


def _eager_us(fn, mesh, calls: int) -> float:
    """Host-clock us a call of fn, every device of this process
    synchronised before and after the calls (after one warm call)."""
    fn()
    _sync(mesh)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    _sync(mesh)
    return (time.perf_counter() - t0) / calls * 1e6


def _replayed_us(capture, replays: int = 20):
    """us a replay of the CUDA graph capture() returns (one replay first),
    or why the capture failed."""
    try:
        graph = capture()
    except RuntimeError as e:
        return f"capture failed: {e}".splitlines()[0][:200]
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / replays * 1e3


def _captured(fn):
    """A CUDA graph of one call of fn, after one eager call on a side
    stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def profile_calls(fn, sync, calls: int = 5, trace: str | None = None):
    """torch.profiler over `calls` warm calls of fn (sync() after them):
    (its key_averages table, sorted by host time, and a summary a call:
    the host wall, the device time of kernels and of copies by kind
    (summed over the cards), and the count and host time of each CUDA
    runtime call, e.g. launches, copies, event records and waits,
    synchronisations). trace: a path for the Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        sync()
        wall = time.perf_counter() - t0
    if trace:
        prof.export_chrome_trace(trace)
    ka = prof.key_averages()
    summary = {"wall_us": wall / calls * 1e6, "kernel_us": 0.0,
               "runtime": {}, "copies": {}}
    for e in ka:
        dev_us = getattr(e, "device_time_total", 0.0) / calls
        if e.key.startswith("cuda"):
            summary["runtime"][e.key] = [e.count / calls,
                                         e.cpu_time_total / calls]
        elif e.key.startswith(("Memcpy", "Memset")):
            summary["copies"][e.key] = [e.count / calls, dev_us]
        elif dev_us and str(getattr(e, "device_type", "")).endswith("CUDA"):
            summary["kernel_us"] += dev_us
    return ka.table(sort_by="cpu_time_total", row_limit=30), summary


def _max_err(ys, ps) -> list:
    """[max |kernel - plain|, max |plain|] over this process's rows."""
    err = scale = 0.0
    for y, p in zip(ys, ps):
        if y is not None:
            err = max(err, float((y - p).abs().max()))
            scale = max(scale, float(p.abs().max()))
    return [err, scale]


def run_paths(built: Built, mesh, axis="rows", check: bool = False,
              time_calls: bool = False, cg_iters: int = 3,
              pcg_iters: int = 25) -> tuple:
    """Run the suite's paths on `mesh` (its own shards only) and return
    ({path: the result's shards, None for another process's}, {path:
    facts}). check: also each path's call through the plain versions
    (facts "plain": max |kernel - plain| and max |plain| over this
    process's rows). time_calls: eager us a call (an iteration for the
    solvers), and with NCCL from a CUDA graph."""
    from tpu_spmv_torch.dist import sharding as dsh
    from tpu_spmv_torch.dist import solvers
    from tpu_spmv_torch.dist.sts import sts_solve_sharded
    from tpu_spmv_torch.sts import ic0

    def vec(v, padded_m):
        return dsh.shard_vector(v, mesh, padded_m)

    out, facts = {}, {}
    lay = built.ranked.device_put(mesh, axis)
    xs = vec(built.x, lay.padded_m)

    def call(name, fn, plain_fn=None, calls=20):
        out[name] = fn()
        f = facts.setdefault(name, {})
        if check and plain_fn is not None:
            f["plain"] = _max_err(out[name], plain_fn())
        if time_calls:
            f["eager_us"] = _eager_us(fn, mesh, calls)
            if solvers.graph_default(mesh):
                f["graph_us"] = _replayed_us(lambda: _captured(fn))

    call("spmv", lambda: dsh.spmv_sharded(lay, xs, mesh, axis),
         lambda: dsh.spmv_sharded(lay, xs, mesh, axis, plain=True))
    facts["spmv"]["halo"] = lay.halo
    if built.gathered is not None:
        g = built.gathered.device_put(mesh, axis)
        call("spmv_allgather", lambda: dsh.spmv_sharded(g, xs, mesh, axis))
        facts["spmv_allgather"]["halo"] = g.halo
    if built.X is not None:
        Xs = vec(built.X, lay.padded_m)
        call("spmm", lambda: dsh.spmm_sharded(lay, Xs, mesh, axis),
             lambda: dsh.spmm_sharded(lay, Xs, mesh, axis, plain=True))
    if built.overlap is not None:
        ov = built.overlap.device_put(mesh, axis)
        call("overlap", lambda: dsh.spmv_overlap(ov, xs, mesh, axis),
             lambda: dsh.spmv_overlap(ov, xs, mesh, axis, plain=True))
        facts["overlap"].update(halo=ov.halo, edge_nnz=ov.edge.nnz)

    cl = built.cg_layout.device_put(mesh, axis) if (
        built.cg_layout is not built.ranked) else lay
    b = vec(np.ones(built.cg.m, np.float32), cl.padded_m)
    f = facts["cg"] = {"iters": cg_iters}
    t0 = time.perf_counter()
    out["cg"], rz = solvers.cg_solve(cl, b, mesh, iters=cg_iters, axis=axis,
                                     graph=False)
    _sync(mesh)
    f["rz"] = float(rz)
    if time_calls:
        f["eager_us"] = (time.perf_counter() - t0) / cg_iters * 1e6
        if solvers.graph_default(mesh):
            state = solvers.cg_init(b, mesh)
            f["graph_us"] = _replayed_us(
                lambda: solvers.capture_step(cl, mesh, state, axis=axis))
    if built.sts_layout is None:
        return out, facts

    sl = built.sts_layout.device_put(mesh, axis)
    call("sts", lambda: sts_solve_sharded(sl, mesh, axis),
         lambda: sts_solve_sharded(sl, mesh, axis, plain=True), calls=5)
    il = built.ic0_layout.device_put(mesh, axis) if (
        built.ic0_layout is not built.cg_layout) else cl
    b = vec(np.ones(built.ic0.m, np.float32), il.padded_m)
    r = vec(np.random.default_rng(X_SEED).standard_normal(
        built.ic0.m).astype(np.float32), il.padded_m)
    for name, pre in built.precond.items():
        pre = pre.device_put(mesh, axis)
        f = facts[name] = {"iters": pcg_iters, "breakdowns": pre.breakdowns}
        if check:
            f["plain"] = _max_err(pre.apply(r, mesh, axis),
                                  pre.apply(r, mesh, axis, plain=True))
        t0 = time.perf_counter()
        out[name], rz = ic0.pcg_ic0_sharded(il, b, pre, mesh, axis,
                                            iters=pcg_iters, graph=False)
        _sync(mesh)
        f["rz"] = float(rz)
        if time_calls:
            f["eager_us"] = (time.perf_counter() - t0) / pcg_iters * 1e6
    return out, facts


def _counters() -> list:
    from tpu_spmv_torch.kernels import cg, sell, spmm, sts

    return [sell.spmv_ranked, sell.spmv_sell, spmm.spmm_ranked,
            spmm.spmm_ranked_windowed, sts.lower_solve_blocks,
            cg.spmv_ranked_dot, cg.cg_update, cg.cg_direction]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--suite", choices=("small", "full", "times"),
                    default="small")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True)
    ap.add_argument("--cg-iters", type=int, default=3)
    ap.add_argument("--pcg-iters", type=int, default=25)
    ap.add_argument("--check", action="store_true",
                    help="hold each path to its plain version")
    ap.add_argument("--time", action="store_true",
                    help="time each path (eager; NCCL: a CUDA graph too)")
    ap.add_argument("--profile", metavar="PATH",
                    help="after the paths, profile 5 spmv_sharded calls; "
                    "rank 0 writes PATH.txt (the table) and PATH.json "
                    "(the Chrome trace)")
    ap.add_argument("--coordinator")
    ap.add_argument("--num-processes", type=int)
    ap.add_argument("--process-id", type=int)
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from tpu_spmv_torch.dist import multihost

    if args.device == "cpu":
        torch.set_num_threads(1)  # processes share the cores
    how = "args" if args.coordinator else "env"
    first = multihost.initialize(args.coordinator, args.num_processes,
                                 args.process_id, device=args.device)
    again = multihost.initialize(args.coordinator, args.num_processes,
                                 args.process_id, device=args.device)
    rank, world = multihost.process_index(), multihost.process_count()
    dev = multihost.process_device(rank, args.device)
    facts = dict(rank=rank, world=world, how=how, initialize=[first, again],
                 backend=multihost.backend(), device=str(dev))
    if dev.type == "cuda":
        from tpu_spmv_torch.kernels import _build

        facts["library_stale"] = _build._stale()
        facts["card"] = torch.cuda.get_device_name(dev)
    mesh = multihost.make_hybrid_mesh(devices=[dev] * (SHARDS // world))
    facts["mesh_shape"] = list(mesh.shape)
    facts["local"] = mesh.local
    built = build(args.suite)
    facts["host_build_s"] = built.seconds
    counters = _counters()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    rows, facts["paths"] = run_paths(
        built, mesh, multihost.row_spec(), check=args.check,
        time_calls=args.time, cg_iters=args.cg_iters,
        pcg_iters=args.pcg_iters)
    facts["paths_s"] = time.perf_counter() - t0
    facts["launches"] = {c.__name__: c.launches for c in counters}
    if args.profile:
        from tpu_spmv_torch.dist import sharding as dsh

        lay = built.ranked.device_put(mesh, multihost.row_spec())
        xs = dsh.shard_vector(built.x, mesh, lay.padded_m)
        table, facts["profile"] = profile_calls(
            lambda: dsh.spmv_sharded(lay, xs, mesh, multihost.row_spec()),
            lambda: (_sync(mesh), dist.barrier()),
            trace=f"{args.profile}.json" if rank == 0 else None)
        if rank == 0:
            pathlib.Path(f"{args.profile}.txt").write_text(table)
    out = pathlib.Path(args.out)
    np.savez(out / f"rank{rank}.npz", **{
        f"{name}/{d}": t.cpu().numpy() for name, ts in rows.items()
        for d, t in enumerate(ts) if t is not None})
    (out / f"rank{rank}.json").write_text(json.dumps(facts))
    dist.destroy_process_group()
    print(f"OK process {rank}", flush=True)
    return 0


_VARS = ("TPU_SPMV_COORDINATOR", "TPU_SPMV_NUM_PROCESSES",
         "TPU_SPMV_PROCESS_ID")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(n: int, argv: list, out: str, timeout_s: float,
          args_ranks=()) -> list:
    """Start n processes of this module (argv after the module name, with
    --out `out`) on one free port of this machine, and wait for all
    within timeout_s seconds, killing every one still running then.
    Ranks in args_ranks get the group's facts as arguments, the others
    through the environment. On a card, the kernel library is built here
    first, so the processes load it. Returns, per rank, (return code or
    None when killed, its output)."""
    if "--device" in argv and argv[argv.index("--device") + 1] != "cpu":
        from tpu_spmv_torch.kernels import _build

        _build.build()
    port = free_port()
    root = str(pathlib.Path(__file__).resolve().parents[2])
    pathlib.Path(out).mkdir(parents=True, exist_ok=True)
    procs, logs = [], []
    for r in range(n):
        env = {k: v for k, v in os.environ.items() if k not in _VARS}
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, os.environ.get("PYTHONPATH")) if p)
        cmd = [sys.executable, "-m", "tpu_spmv_torch.bench.multiproc",
               *argv, "--out", out]
        if r in args_ranks:
            cmd += ["--coordinator", f"127.0.0.1:{port}", "--num-processes",
                    str(n), "--process-id", str(r)]
        else:
            env.update(TPU_SPMV_COORDINATOR=f"127.0.0.1:{port}",
                       TPU_SPMV_NUM_PROCESSES=str(n),
                       TPU_SPMV_PROCESS_ID=str(r))
        log = open(pathlib.Path(out) / f"rank{r}.log", "w+")
        logs.append(log)
        procs.append(subprocess.Popen(cmd, env=env, stdout=log,
                                      stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout_s
    results = []
    try:
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for p, log in zip(procs, logs):
            log.seek(0)
            results.append((p.returncode if p.returncode >= 0 else None,
                            log.read()))
            log.close()
    return results


def load(out: str, n: int) -> list:
    """Per rank, (facts, {path: {shard d: rows}}) as the processes wrote
    them."""
    res = []
    for r in range(n):
        facts = json.loads((pathlib.Path(out) / f"rank{r}.json").read_text())
        rows = {}
        with np.load(pathlib.Path(out) / f"rank{r}.npz") as z:
            for key in z.files:
                name, d = key.rsplit("/", 1)
                rows.setdefault(name, {})[int(d)] = z[key]
        res.append((facts, rows))
    return res


if __name__ == "__main__":
    sys.exit(main())
