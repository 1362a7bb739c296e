"""Solves of A x = b to the configuration's residual reduction, through
the routes `tools.solve` takes on one card: plain CG over
`ShardedRanked.build(mat, 1)` on a one-shard mesh (`precond` "none"),
or IC(0)-PCG over `RankedSlabs.from_csr` and `IC0Preconditioner.build`
(`precond` "ic0"). One iteration is captured as a CUDA graph
(`capture_step`, `capture_pcg_step`) and replayed; between solves the
captured state is reset in place.

Traffic: a closed loop of solves from x = 0, the right-hand sides a
rotation of `rhs` vectors b = A x_true, in an order drawn from the seed.
The vectors are the configuration's (x_true from its `rhs_seed`, as
HPCG's b is fixed), so every seed does the same work: how many
iterations a solve takes depends on its b. A
solve ends when sqrt(rz / rz0) <= the configuration's `reduction`, rz
being r.r for CG and r.z for PCG, read on the host every `check_every`
iterations; one that reaches `max_iters`, or a NaN, has failed. Each
solve is timed on the host from its start to the read that ends it. A
seeded uniform sample of `sample` solves keeps its x; after the window
`extra` further right-hand sides, their x_true drawn from the run's own
seed, are solved through the same captured iteration. Every kept x is
judged against the float64 solution of the same b on the original
matrix. In a control run (`run.control`) the bfloat16 reference solver
(reference.cg.Bf16Solver) takes the program's place and is judged by
the same check."""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from spmv_bench import roofline
from spmv_bench.core import Reservoir, seed_for
from spmv_bench.reference import cg as ref_cg, rel_l2, spmv as ref_spmv


def _copy_into(state, new) -> None:
    """Advance `state` (tensors, or lists of shard tensors, None for
    another process's) to `new` in place, as a captured iteration
    does."""
    for old, upd in zip(state, new):
        if isinstance(old, list):
            for o, u in zip(old, upd):
                if o is not None:
                    o.copy_(u)
        else:
            old.copy_(upd)


def products(csr, x_true: torch.Tensor, device) -> torch.Tensor:
    """b = A x_true for each row of x_true, the product in float64 on
    the host, float32 on `device`."""
    return ref_spmv.products(csr, x_true).to(torch.float32).to(device)


def rhs(csr, k: int, rhs_seed: int, seed: int, device) -> torch.Tensor:
    """The cell's k right-hand sides (k, n) in an order drawn from
    `seed`: x_true uniform in [0.5, 1.5) from `rhs_seed`."""
    gen = torch.Generator().manual_seed(rhs_seed)
    x_true = torch.rand(k, csr.n, generator=gen) + 0.5
    order = torch.randperm(k, generator=torch.Generator().manual_seed(
        seed_for(seed, "order")))
    return products(csr, x_true[order], device)


def extra_rhs(csr, k: int, seed: int, device) -> torch.Tensor:
    """k further right-hand sides, x_true uniform in [0.5, 1.5) drawn
    from the run's own seed."""
    gen = torch.Generator().manual_seed(seed_for(seed, "extra_rhs"))
    return products(csr, torch.rand(k, csr.n, generator=gen) + 0.5, device)


class Entry:
    def __init__(self, run, csr):
        self.run, self.csr = run, csr
        cfg = run.config
        self.reduction = float(cfg["reduction"])
        self.check_every = int(cfg["check_every"])
        self.max_iters = int(cfg["max_iters"])
        with run.span("input.rhs"):
            self.b = rhs(csr, int(run.traffic["rhs"]), int(cfg["rhs_seed"]),
                         run.seed, self.rhs_device())
        precond = run.traffic["precond"]
        if precond not in ("none", "ic0"):
            raise SystemExit(f"unknown precond {precond!r}")
        run.notes["precond"] = precond
        n, nnz = csr.n, csr.nnz
        if precond == "none":
            self.iter_work = roofline.cg_iteration(n, nnz)
            self.start_work = roofline.cg_start(n)
        else:
            nnz_l = csr.lower_nnz()
            self.iter_work = roofline.pcg_ic0_iteration(n, nnz, nnz_l)
            self.start_work = roofline.pcg_ic0_start(n, nnz_l)
        if run.control:
            self._control(precond)
        else:
            self._program(precond)
        self.bs = [self.prep(b) for b in self.b]
        self.solve(self.bs[0])

    def rhs_device(self):
        """Where the right-hand sides are kept: the run's device."""
        return self.run.device

    def agree(self, go_on: bool) -> bool:
        """Whether the loop goes on: go_on, this process's decision (a
        group's ranks take rank 0's)."""
        return go_on

    def _control(self, precond):
        solver = ref_cg.Bf16Solver(self.csr, precond, self.run.device)
        self.perm = torch.arange(self.csr.n, device=self.run.device)
        self.prep = lambda b: b
        self.state, self.held = solver.state, solver
        self.reset, self.step = solver.reset, solver.step
        self.x = lambda: solver.state[0]
        self.run.notes["order"] = "control_bf16"

    def _program(self, precond):
        from tpu_spmv_torch.formats.csr import CSRMatrix
        from tpu_spmv_torch.tune.model import tpu_plan

        run, csr = self.run, self.csr
        mat = CSRMatrix(csr.indptr, csr.indices, csr.data, (csr.n, csr.n))
        perm, need = np.arange(csr.n), False
        if run.config["rcm"] != "never":
            with run.span("build.plan"):
                need = (run.config["rcm"] == "always"
                        or tpu_plan(mat).needs_rcm)
            if need:
                from tpu_spmv_torch.reorder import rcm

                with run.span("build.rcm"):
                    perm = np.asarray(rcm(mat.indptr, mat.indices), np.int64)
                    mat = mat.permuted(perm)
        run.notes["order"] = "rcm" if need else "natural"
        self.perm = torch.from_numpy(perm).to(run.device)
        if precond == "none":
            self._cg(mat)
        else:
            self._pcg_ic0(mat)

    def _cg(self, mat):
        from tpu_spmv_torch.dist.sharding import (
            ShardedRanked, make_row_mesh,
        )
        from tpu_spmv_torch.dist.solvers import capture_step, cg_init, cg_step

        run, n = self.run, self.csr.n
        with run.span("build.layout"):
            mesh = make_row_mesh([run.device])
            lay = ShardedRanked.build(mat, 1).device_put(mesh)
            run.sync()
        pad = lay.padded_m - n
        self.prep = lambda b: torch.nn.functional.pad(
            b.index_select(0, self.perm), (0, pad))
        self.state = cg_init([self.prep(self.b[0])], mesh)
        x, r, p, rz = self.state

        def reset(b):
            x[0].zero_()
            r[0].copy_(b)
            p[0].copy_(b)
            rz.copy_(torch.dot(b, b))

        self._start(reset, lambda st: cg_step(lay, mesh, st), capture_step,
                    (lay, mesh))
        self.x = lambda: x[0][:n]

    def _pcg_ic0(self, mat):
        from tpu_spmv_torch.formats.sell import RankedSlabs
        from tpu_spmv_torch.sts.ic0 import (
            IC0Preconditioner, capture_pcg_step, pcg_ic0_init, pcg_ic0_step,
        )

        run, n = self.run, self.csr.n
        with run.span("build.layout"):
            lay = RankedSlabs.from_csr(mat).to(run.device)
            run.sync()
        with run.span("build.factor"):
            pre = IC0Preconditioner.build(mat, device=run.device)
            run.sync()
        self.prep = lambda b: b.index_select(0, self.perm)
        self.state = pcg_ic0_init(self.prep(self.b[0]), pre)
        x, r, p, rz = self.state

        def reset(b):
            x.zero_()
            r.copy_(b)
            z = pre.apply(b)
            p.copy_(z)
            rz.copy_(torch.dot(b, z))

        self._start(reset, lambda st: pcg_ic0_step(lay, pre, st),
                    capture_pcg_step, (lay, pre))
        self.x = lambda: x

    def _start(self, reset, step, capture, args):
        """One iteration as a CUDA graph on the card, eager elsewhere.
        args (the layout, the mesh or the preconditioner) are held for
        as long as the graph: it reads their device memory."""
        self.reset, self.held = reset, args
        if self.run.device.type == "cuda":
            graph = capture(*args, self.state)
            self.step = graph.replay
        else:
            self.step = lambda: _copy_into(self.state, step(self.state))

    def solve(self, b: torch.Tensor) -> tuple[bool, int]:
        """One solve of b, in the program's ordering: (converged,
        iterations)."""
        rz = self.state[3]
        self.reset(b)
        stop = float(rz) * self.reduction ** 2
        it = 0
        while it < self.max_iters:
            for _ in range(self.check_every):
                self.step()
            it += self.check_every
            v = float(rz)
            if not math.isfinite(v):
                return False, it
            if v <= stop:
                return True, it
        return False, it

    def window(self, seconds: float) -> None:
        run, k = self.run, len(self.bs)
        self.sample = Reservoir(int(run.traffic["sample"]), run.seed)
        nxt, i, iters, failed = self.sample.next, 0, 0, 0
        run.sync()
        self.agree(True)
        t0 = time.perf_counter()
        end = t0 + seconds
        while True:
            ts = time.perf_counter()
            ok, it = self.solve(self.bs[i % k])
            te = time.perf_counter()
            run.solve_s.append(te - ts)
            iters += it
            failed += not ok
            if i == nxt:
                nxt = self.sample.take(i, (i % k, self.x().clone()))
            i += 1
            if not self.agree(te < end):
                break
        run.window_s = te - t0
        run.counts.update(solves=i, iters=iters, failed_solves=failed)

    def traced(self, seconds: float):
        k, i, iters = len(self.bs), 0, 0
        end = time.perf_counter() + seconds
        while self.agree(time.perf_counter() < end):
            iters += self.solve(self.bs[i % k])[1]
            i += 1
        self.run.counts["traced_iters"] = iters
        return self.iter_work * iters + self.start_work * i

    def check(self):
        run = self.run
        samples = list(self.sample.items)
        bs = list(self.b)
        failed = run.counts["failed_solves"]
        for b in extra_rhs(self.csr, int(run.traffic["extra"]), run.seed,
                           run.device):
            ok, _ = self.solve(self.prep(b))
            failed += not ok
            samples.append((len(bs), self.x().clone()))
            bs.append(b)
        del self.state, self.step, self.reset, self.x, self.held, self.prep
        if run.device.type == "cuda":
            torch.cuda.empty_cache()
        refs = {k: ref_cg.solve(self.csr, bs[k])
                for k in sorted({k for k, _ in samples})}
        limit = run.limits["rel_err"]
        worst, wrong = 0.0, 0
        for k, x in samples:
            x_orig = torch.empty_like(x)
            x_orig[self.perm] = x
            err = rel_l2(x_orig, refs[k])
            if math.isnan(err) or err > worst:
                worst = err
            wrong += not err <= limit
        return {"rel_err": worst, "failed_solves": failed}, wrong + failed
