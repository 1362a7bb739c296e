"""Times of the distributed layer (tpu_spmv_torch.dist) on the card(s).

    python -m tpu_spmv_torch.bench.dist_times [--iters 1600]
    python -m tpu_spmv_torch.bench.dist_times --cards [--procs 4]
        [--profile DIR]

One card (the default): D shards on it, D = 1 and 4.
  * Where the streams go: spmv_sharded over ShardedRanked on lap2d_1024
    after RCM and lap3d_101 (warm TimeMin, CUDA graph,
    bench/harness.bench_spmv, twice each) beside spmv_ranked alone, with
    the shards' kernels (a) each on a stream of its own, shard 0 too,
    (b) as make_row_mesh places them, shard 0 on the caller's stream,
    (c) all on the caller's stream, one after the other.
  * CG and Jacobi-PCG on lap3d_101 (b = ones): us per iteration of a
    captured iteration replayed `--iters` times, as capture_step takes
    it (CG: the fused kernels, kernels/cg.py; Jacobi-PCG: one
    torch.addcmul an update) and with the updates split into a multiply
    and an add (as a first version had them), and the RMS
    residual at 100, 200, 400, ... iterations.

  * The sharded triangular solve (dist/sts.py) on lap2d_1024 LS at D = 1,
    2 and 4 (warm TimeMin, CUDA graph, twice each, beside
    lower_solve_blocks alone), and IC(0)-PCG on lap3d_101 with
    ShardedIC0Preconditioner and BlockJacobiIC0Preconditioner at D = 1, 2
    and 4: us per iteration of a captured iteration (20 replays) and the
    RMS residual after 60.

--cards: one shard a card (make_row_mesh() over every card). Each
sharded call (ranked, all-gather, sell, the overlap; SpMV and SpMM at
B = 8) on lap2d_1024 after RCM against its plain version and the oracle,
with its eager time (host clock, every card synchronised; one CUDA graph
cannot hold several cards), then cg_solve on lap3d_101 eagerly; then the
sharded solve on lap2d_1024 LS (against the float64 substitution) and
both IC(0)-PCG iterations on lap3d_101, eagerly.

--procs N: N processes of a group (bench/multiproc.py, suite "times"),
a card each: NCCL when every process has a card of its own, else gloo
(multihost.initialize's rule). Each times spmv_sharded on lap2d_1024
after RCM (eager us a call, host clock; and a replay from a CUDA graph
where capture works) and cg_solve on lap3d_101 (us an iteration, eager
and captured), beside --cards when both are given.

--profile DIR: a torch.profiler trace of 5 warm spmv_sharded calls of
--cards (DIR/cards.txt, .json) and of --procs (rank 0: DIR/procs.txt,
.json), and a line each: host wall a call, kernel and copy time on the
cards, and the CUDA runtime calls a call (launches, copies, event
records and waits, synchronisations).

The first line is the card's nvidia-smi name and power limit. Exits 1
when a check fails.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import tempfile
import time

import numpy as np
import torch


def _sharded_us(lay, xs, mesh) -> str:
    from tpu_spmv_torch.bench.harness import bench_spmv
    from tpu_spmv_torch.dist.sharding import spmv_sharded

    def call(lay_, _x):
        return spmv_sharded(lay_, xs, mesh)

    return " ".join(f"{bench_spmv(call, lay, xs[0]).time_min * 1e6:.2f}"
                    for _ in range(2))


def _streams(dev) -> None:
    from tpu_spmv_torch.bench.harness import bench_spmv
    from tpu_spmv_torch.dist import sharding as dsh
    from tpu_spmv_torch.kernels.sell import spmv_ranked
    from tpu_spmv_torch.tools.spmv import load_input, prepare

    for name, rcm in (("lap2d_1024", "always"), ("lap3d_101", "never")):
        mat = load_input(f"synthetic:{name}")
        a = prepare(mat, rcm)[0].matrix if rcm == "always" else mat
        x = np.random.default_rng(0).standard_normal(a.n).astype(np.float32)
        for D in (1, 4):
            mesh = dsh.make_row_mesh([dev] * D)
            lay = dsh.ShardedRanked.build(a, D).device_put(mesh)
            xs = dsh.shard_vector(x, mesh, lay.padded_m)
            own = dsh.RowMesh(mesh.devices, [torch.cuda.Stream(dev)
                                             for _ in range(D)],
                              mesh.halo_streams)
            caller = dsh.RowMesh(mesh.devices, [None] * D, mesh.halo_streams)
            alone = ""
            if D == 1:
                t = [bench_spmv(spmv_ranked, lay.shards[0], xs[0][: a.n])
                     .time_min * 1e6 for _ in range(2)]
                alone = "spmv_ranked alone " + " ".join(
                    f"{v:.2f}" for v in t) + " | "
            print(f"{name} D={D} halo={lay.halo}: {alone}sharded, a stream "
                  f"a shard {_sharded_us(lay, xs, own)} | shard 0 on the "
                  f"caller's {_sharded_us(lay, xs, mesh)} | all on the "
                  f"caller's {_sharded_us(lay, xs, caller)} (warm TimeMin "
                  "us, CUDA graph)", flush=True)


def _split_step(layout, mesh, inv_diag, state):
    """One (P)CG iteration with each vector update as a multiply and an
    add: dist/solvers' arithmetic in twice the launches."""
    from tpu_spmv_torch.dist.solvers import _dot, _spmv_any

    x, r, p, rz = state
    Ap = _spmv_any(layout, p, mesh)
    alpha = rz / torch.clamp_min(_dot(p, Ap, mesh), 1e-30)
    x = [xi + alpha.to(xi.device) * pi for xi, pi in zip(x, p)]
    r = [ri - alpha.to(ri.device) * ai for ri, ai in zip(r, Ap)]
    z = r if inv_diag is None else [ri * di for ri, di in zip(r, inv_diag)]
    rz_new = _dot(r, z, mesh)
    beta = rz_new / torch.clamp_min(rz, 1e-30)
    p = [zi + beta.to(zi.device) * pi for zi, pi in zip(z, p)]
    return (x, r, p, rz_new)


def _cg(dev, iters: int) -> bool:
    from tpu_spmv_torch.dist import sharding as dsh
    from tpu_spmv_torch.dist import solvers
    from tpu_spmv_torch.tools.spmv import load_input

    mat = load_input("synthetic:lap3d_101")
    ok = True
    for D in (1, 4):
        mesh = dsh.make_row_mesh([dev] * D)
        lay = dsh.ShardedRanked.build(mat, D).device_put(mesh)
        b = dsh.shard_vector(np.ones(mat.m, np.float32), mesh, lay.padded_m)
        jac = dsh.shard_vector(
            solvers.jacobi_inv_diag(mat.diagonal(), lay.padded_m), mesh)
        for inv in (None, jac):
            for updates in ("capture_step", "multiply + add"):
                state = (solvers.cg_init(b, mesh) if inv is None
                         else solvers.pcg_init(b, mesh, inv))
                if updates == "capture_step":
                    graph = solvers.capture_step(lay, mesh, state, inv)
                else:
                    graph = solvers.capture(
                        lambda s: _split_step(lay, mesh, inv, s), mesh, state)
                done, ms, res = 0, 0.0, []
                upto = 100
                while done < iters:
                    upto = min(upto, iters)
                    start = torch.cuda.Event(enable_timing=True)
                    stop = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(upto - done):
                        graph.replay()
                    stop.record()
                    stop.synchronize()
                    ms += start.elapsed_time(stop)
                    done = upto
                    x = dsh.gather_vector(state[0])[: mat.m]
                    rms = np.linalg.norm(mat.matvec(x) - 1.0) / np.sqrt(mat.m)
                    res.append(f"{rms:.3e}@{done}")
                    upto *= 2
                ok &= done < 200 or rms < 1e-3
                print(f"lap3d_101 {'CG' if inv is None else 'Jacobi-PCG'} "
                      f"D={D} ({updates}): {ms / iters * 1e3:.2f} us an "
                      f"iteration (CUDA graph); rms_residual "
                      f"{' '.join(res)}", flush=True)
    return ok


def _solve_system():
    """lap2d_1024 in level order, b for x = ones, and the float64
    forward substitution."""
    from tpu_spmv_torch.sts.host import build_sts, compute_b
    from tpu_spmv_torch.tools.spmv import load_input

    sys_ = build_sts(load_input("synthetic:lap2d_1024"), order_type="LS")
    return sys_, compute_b(sys_.lower)


def _graph_us(graph, replays: int = 20) -> float:
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / replays * 1e3


def _solves(dev) -> bool:
    """The sharded solve and both distributed IC(0)-PCG iterations, D
    shards on one card (CUDA graphs)."""
    from tpu_spmv_torch.bench.harness import bench_spmv
    from tpu_spmv_torch.dist import sharding as dsh
    from tpu_spmv_torch.dist.sts import ShardedLowerSolve, sts_solve_sharded
    from tpu_spmv_torch.kernels.sts import lower_solve_blocks
    from tpu_spmv_torch.sts import ic0
    from tpu_spmv_torch.sts.solve import LowerSolveLayout
    from tpu_spmv_torch.tools.spmv import load_input

    ok = True
    sys_, b = _solve_system()
    one = LowerSolveLayout.build(sys_, b, ranked=False)
    def blocks(lay, v):
        return lower_solve_blocks(lay, v.view(-1, 128))

    alone = [bench_spmv(blocks, one.slabs, one.b_scale.reshape(-1)).time_min
             * 1e6 for _ in range(2)]
    print("lap2d_1024 LS lower_solve_blocks alone "
          + " ".join(f"{t:.2f}" for t in alone) + " us", flush=True)
    del one
    for D in (1, 2, 4):
        mesh = dsh.make_row_mesh([dev] * D)
        lay, pad = ShardedLowerSolve.build(sys_, b, D)
        lay = lay.device_put(mesh)
        x = dsh.gather_vector(sts_solve_sharded(lay, mesh))[pad]
        wrong = int(np.sum(np.abs(x - 1.0) > 0.01))
        ok &= wrong == 0
        t = [bench_spmv(lambda lay_, _v: sts_solve_sharded(lay_, mesh), lay,
                        lay.b_local[0], nnz=sys_.lower.nnz).time_min * 1e6
             for _ in range(2)]
        print(f"lap2d_1024 LS sts_solve_sharded D={D}: Number Wrong {wrong} |"
              " " + " ".join(f"{v:.2f}" for v in t) + " us (warm TimeMin, "
              "CUDA graph)", flush=True)
        del lay
    mat = load_input("synthetic:lap3d_101")
    for D in (1, 2, 4):
        mesh = dsh.make_row_mesh([dev] * D)
        lay = dsh.ShardedRanked.build(mat, D).device_put(mesh)
        b3 = dsh.shard_vector(np.ones(mat.m, np.float32), mesh, lay.padded_m)
        for cls in (ic0.ShardedIC0Preconditioner,
                    ic0.BlockJacobiIC0Preconditioner):
            t0 = time.perf_counter()
            pre = cls.build(mat, D, lay.padded_m).device_put(mesh)
            build_s = time.perf_counter() - t0
            state = ic0.pcg_ic0_sharded_init(b3, pre, mesh)
            graph = ic0.capture_pcg_sharded_step(lay, pre, mesh, state)
            us = _graph_us(graph)
            for _ in range(60 - 21):
                graph.replay()
            x = dsh.gather_vector(state[0])[: mat.m]
            rms = np.linalg.norm(mat.matvec(x) - 1.0) / np.sqrt(mat.m)
            ok &= rms < 1e-3
            print(f"lap3d_101 {cls.__name__} D={D}: {us:.2f} us an "
                  f"iteration (CUDA graph); rms_residual {rms:.3e} after 60 "
                  f"| host build {build_s:.2f} s", flush=True)
            del pre, state, graph
    return ok


def _cards(profile: str | None) -> bool:
    from tpu_spmv_torch.bench.harness import validate
    from tpu_spmv_torch.dist import sharding as dsh
    from tpu_spmv_torch.dist import solvers
    from tpu_spmv_torch.tools.spmv import load_input, prepare

    mesh = dsh.make_row_mesh()
    D = mesh.size

    def sync():
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)

    def eager_us(fn, k=20):
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(k):
            fn()
        sync()
        return (time.perf_counter() - t0) / k * 1e6

    peer = [[torch.cuda.can_device_access_peer(i, j) for j in range(D)
             if j != i] for i in range(D)]
    ranked = None
    print(f"mesh: {[str(d) for d in mesh.devices]}, peer access {peer}",
          flush=True)
    a = prepare(load_input("synthetic:lap2d_1024"), "always")[0].matrix
    ok = True
    for name, lay in (("ranked", dsh.ShardedRanked.build(a, D)),
                      ("ranked all-gather",
                       dsh.ShardedRanked.build(a, D, halo="never")),
                      ("sell", dsh.ShardedSell.build(a, D)),
                      ("overlap", dsh.OverlapRanked.build(a, D))):
        lay = lay.device_put(mesh)
        for B in (None, 8):
            if B and name in ("sell", "ranked all-gather"):
                continue
            over = name == "overlap"
            if B is None:
                call = dsh.spmv_overlap if over else dsh.spmv_sharded
            else:
                call = dsh.spmm_overlap if over else dsh.spmm_sharded
            shape = (a.n,) if B is None else (a.n, B)
            x = np.random.default_rng(0).standard_normal(shape).astype(
                np.float32)
            xs = dsh.shard_vector(x, mesh, lay.padded_m)
            y = dsh.gather_vector(call(lay, xs, mesh))[: a.m]
            yp = dsh.gather_vector(call(lay, xs, mesh, plain=True))[: a.m]
            xc = x.reshape(a.n, -1)
            ref = np.stack([a.matvec(xc[:, c]) for c in range(xc.shape[1])],
                           1)
            wrong, rel = validate(y.reshape(a.m, -1), ref)
            err = float(np.abs(y - yp).max())
            good = wrong == 0 and rel <= 1e-6 and err <= 1e-5 * max(
                1.0, float(np.abs(yp).max()))
            ok &= good
            print(f"lap2d_1024 rcm {name} B={B or 1} D={D} halo={lay.halo}: "
                  f"Number Wrong {wrong}, RelL2 {rel:.3g}, max|kernel-plain| "
                  f"{err:.3g} | eager us a call "
                  f"{eager_us(lambda: call(lay, xs, mesh)):.2f} | "
                  f"{'ok' if good else 'FAILED'}", flush=True)
            if name == "ranked" and B is None:
                ranked = (lay, xs)
    if profile:
        from tpu_spmv_torch.bench.multiproc import profile_calls

        lay, xs = ranked
        table, summary = profile_calls(
            lambda: dsh.spmv_sharded(lay, xs, mesh), sync,
            trace=f"{profile}/cards.json")
        (pathlib.Path(profile) / "cards.txt").write_text(table)
        print(f"profile --cards spmv_sharded ranked D={D}: "
              f"{json.dumps(summary)}", flush=True)
    mat = load_input("synthetic:lap3d_101")
    lay = dsh.ShardedRanked.build(mat, D).device_put(mesh)
    b = dsh.shard_vector(np.ones(mat.m, np.float32), mesh, lay.padded_m)
    t0 = time.perf_counter()
    x, _ = solvers.cg_solve(lay, b, mesh, iters=200)
    sync()
    dt = time.perf_counter() - t0
    x = dsh.gather_vector(x)[: mat.m]
    res = float(np.linalg.norm(mat.matvec(x) - 1.0) / np.sqrt(mat.m))
    ok &= res < 1e-3
    print(f"cg_solve lap3d_101 D={D} eager: 200 iterations, rms_residual "
          f"{res:.3e}, {dt / 200 * 1e6:.2f} us an iteration (host clock)",
          flush=True)

    from tpu_spmv_torch.dist.sts import ShardedLowerSolve, sts_solve_sharded
    from tpu_spmv_torch.sts import ic0

    sys_, b = _solve_system()
    slay, pad = ShardedLowerSolve.build(sys_, b, D)
    slay = slay.device_put(mesh)
    x = dsh.gather_vector(sts_solve_sharded(slay, mesh))[pad]
    rel = float(np.linalg.norm(x - 1.0) / np.sqrt(x.size))
    ok &= rel <= 1e-5
    print(f"lap2d_1024 LS sts_solve_sharded D={D}: RMS |x - 1| {rel:.3g} | "
          f"eager us a solve "
          f"{eager_us(lambda: sts_solve_sharded(slay, mesh), k=5):.2f}",
          flush=True)
    del slay
    b3 = dsh.shard_vector(np.ones(mat.m, np.float32), mesh, lay.padded_m)
    for cls in (ic0.ShardedIC0Preconditioner,
                ic0.BlockJacobiIC0Preconditioner):
        pre = cls.build(mat, D, lay.padded_m).device_put(mesh)
        state = ic0.pcg_ic0_sharded_init(b3, pre, mesh)
        t0 = time.perf_counter()
        for _ in range(60):
            state = ic0.pcg_ic0_sharded_step(lay, pre, mesh, state)
        sync()
        dt = time.perf_counter() - t0
        x = dsh.gather_vector(state[0])[: mat.m]
        res = float(np.linalg.norm(mat.matvec(x) - 1.0) / np.sqrt(mat.m))
        ok &= res < 1e-3
        print(f"lap3d_101 {cls.__name__} D={D} eager: 60 iterations, "
              f"rms_residual {res:.3e}, {dt / 60 * 1e6:.2f} us an iteration "
              "(host clock)", flush=True)
    return ok


def _procs(n: int, profile: str | None) -> bool:
    """N processes, a card each (bench/multiproc.py, suite "times")."""
    from tpu_spmv_torch.bench import multiproc
    from tpu_spmv_torch.tools.spmv import load_input

    argv = ["--suite", "times", "--device", "cuda", "--time",
            "--cg-iters", "200"]
    if profile:
        argv += ["--profile", f"{profile}/procs"]
    with tempfile.TemporaryDirectory() as out:
        res = multiproc.spawn(n, argv, out, 300)
        for r, (code, log) in enumerate(res):
            if code != 0:
                print(f"--procs {n}: process {r} failed ({code}):\n"
                      f"{log[-3000:]}", flush=True)
                return False
        loaded = multiproc.load(out, n)
    mat = load_input("synthetic:lap3d_101")
    got = {d: y for _, rows in loaded for d, y in rows["cg"].items()}
    x = np.concatenate([got[d] for d in sorted(got)])[: mat.m]
    res = float(np.linalg.norm(mat.matvec(x) - 1.0) / np.sqrt(mat.m))
    for facts, _ in loaded:
        p = facts["paths"]
        print(f"--procs {n} process {facts['rank']} ({facts['backend']}, "
              f"{facts['device']}, {facts['card']}): spmv_sharded ranked "
              f"lap2d_1024 rcm halo={p['spmv']['halo']} eager us a call "
              f"{p['spmv']['eager_us']:.2f}, graph {p['spmv'].get('graph_us')}"
              f" | cg_solve lap3d_101 us an iteration eager "
              f"{p['cg']['eager_us']:.2f}, graph {p['cg'].get('graph_us')}",
              flush=True)
        if "profile" in facts:
            print(f"profile --procs {n} rank {facts['rank']} spmv_sharded: "
                  f"{json.dumps(facts['profile'])}", flush=True)
    print(f"--procs {n}: cg_solve lap3d_101, 200 iterations, rms_residual "
          f"{res:.3e}", flush=True)
    return res < 1e-3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--iters", type=int, default=1600)
    ap.add_argument("--cards", action="store_true",
                    help="one shard a card, over every card")
    ap.add_argument("--procs", type=int, default=0,
                    help="N processes, one card each")
    ap.add_argument("--profile", metavar="DIR",
                    help="profile one SpMV call of --cards and --procs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the times are the card's")

    from tpu_spmv_torch import hw

    print(hw.nvidia_smi(), flush=True)
    if args.profile:
        pathlib.Path(args.profile).mkdir(parents=True, exist_ok=True)
    if args.cards or args.procs:
        ok = not args.cards or _cards(args.profile)
        return 0 if (not args.procs or _procs(args.procs, args.profile)) \
            and ok else 1
    dev = torch.device("cuda")
    _streams(dev)
    ok = _cg(dev, args.iters)
    return 0 if _solves(dev) and ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
