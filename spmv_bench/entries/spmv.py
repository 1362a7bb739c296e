"""y = A x through the port's planned route, as `tools.spmv` takes it:
`prepare` (RCM per the configuration's `rcm`), `tpu_plan` on the
reordered matrix, `build_layout` with the planned kernel.

Traffic: one caller issues calls back to back, eagerly, cycling through
`inputs` seeded vectors (in the port's ordering, permuted once at
set-up), and synchronizes only when the window ends, as a solver's
inner loop does. A seeded uniform sample of `sample` calls is kept and
judged after the window against the float64 product on the original
matrix, mapped back through the port's permutation. In a control run
(`run.control`) the bfloat16 reference takes the program's place and is
judged by the same check."""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from spmv_bench import roofline
from spmv_bench.core import Reservoir
from spmv_bench.reference import rel_l2, spmv as ref_spmv

ISSUE_BURST = 32
ISSUE_BURSTS = 200


def inputs(csr, k: int, gen: torch.Generator) -> torch.Tensor:
    """The cell's k input vectors (k, n), in the original order, on the
    generator's device."""
    return torch.randn(k, csr.n, generator=gen, device=gen.device)


class Entry:
    def __init__(self, run, csr):
        self.run, self.csr = run, csr
        if run.control:
            self.layout, self.fn = ref_spmv.control(csr, run.device)
            perm = np.arange(csr.n)
            run.notes["kernel"] = "control_bf16"
        else:
            perm = self._build()
        perm = np.asarray(perm, np.int64)
        if perm.shape != (csr.n,) or not np.array_equal(
                np.bincount(perm, minlength=csr.n), np.ones(csr.n)):
            raise SystemExit("the port's permutation is not a bijection")
        self.perm = torch.from_numpy(perm).to(run.device)
        self.work = roofline.spmv(csr.n, csr.nnz)
        k = int(run.traffic["inputs"])
        self.x = inputs(csr, k, run.generator())
        self.xs = [self.x[i].index_select(0, self.perm) for i in range(k)]
        for x in self.xs:
            self.fn(self.layout, x)
        run.sync()

    def _build(self):
        """The program's route; returns its permutation."""
        from tpu_spmv_torch.formats.csr import CSRMatrix
        from tpu_spmv_torch.tools.spmv import build_layout, prepare
        from tpu_spmv_torch.tune.model import tpu_plan

        run, csr = self.run, self.csr
        mat = CSRMatrix(csr.indptr, csr.indices, csr.data, (csr.n, csr.n))
        with run.span("build.prepare"):
            ck, perm, plan = prepare(mat, run.config["rcm"], with_plan=True)
        if plan is None:
            with run.span("build.plan"):
                plan = tpu_plan(ck.matrix)
        if plan.sigma:
            raise SystemExit(f"the plan asks for a sigma = {plan.sigma} row "
                             "sort, which this runner does not apply")
        with run.span("build.layout"):
            self.layout, self.fn, kernel = build_layout(
                ck.matrix, plan.kernel, None, plan.bin_blocks, run.device)
            run.sync()
        run.notes["kernel"] = kernel
        return perm

    def window(self, seconds: float) -> None:
        fn, layout, xs, k = self.fn, self.layout, self.xs, len(self.xs)
        self.sample = Reservoir(int(self.run.traffic["sample"]),
                                self.run.seed)
        take, nxt, i = self.sample.take, self.sample.next, 0
        self.run.sync()
        t0 = time.perf_counter()
        end = t0 + seconds
        while True:
            y = fn(layout, xs[i % k])
            if i == nxt:
                nxt = take(i, (i % k, y))
            i += 1
            if time.perf_counter() >= end:
                break
        self.run.sync()
        self.run.window_s = time.perf_counter() - t0
        self.run.counts["calls"] = i

    def issue(self) -> None:
        """Host seconds to issue one call, from bursts short enough that
        the launch queue never fills, each after a synchronize."""
        fn, layout, xs, k = self.fn, self.layout, self.xs, len(self.xs)
        out = []
        for _ in range(ISSUE_BURSTS):
            self.run.sync()
            t0 = time.perf_counter()
            for j in range(ISSUE_BURST):
                fn(layout, xs[j % k])
            out.append((time.perf_counter() - t0) / ISSUE_BURST)
        self.run.sync()
        self.run.issue_s = out

    def traced(self, seconds: float):
        fn, layout, xs, k = self.fn, self.layout, self.xs, len(self.xs)
        i = 0
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            fn(layout, xs[i % k])
            i += 1
        self.run.sync()
        return self.work * i

    def check(self):
        samples = self.sample.items
        del self.layout, self.fn, self.xs
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()
        ref = ref_spmv.products(self.csr, self.x)
        limit = self.run.limits["rel_l2"]
        worst, wrong = 0.0, 0
        for k, y in samples:
            y_orig = torch.empty_like(y)
            y_orig[self.perm] = y
            err = rel_l2(y_orig, ref[k])
            if math.isnan(err) or err > worst:
                worst = err
            wrong += not err <= limit
        return {"rel_l2": worst}, wrong
