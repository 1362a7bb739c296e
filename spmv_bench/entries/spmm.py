"""Y = A X for a block of B columns through the port's planned SpMM
route, as `tools.spmm` takes it: `prepare` (RCM per the configuration's
`rcm`), then `tools.spmm.build_spmm(..., "auto", B)`, which plans the
reordered matrix (`tpu_plan`) and takes the packed walk, the resident
ranked walk or the ranked ring in shared memory by the plan and the L2
gate on X. The route taken is recorded in the result's `route`.

Traffic: one caller issues block calls back to back, eagerly, cycling
through `inputs` seeded (n, B) blocks (B the mix's `columns`, in the
port's ordering, permuted once at set-up), and synchronizes only when
the window ends, as a block-Krylov solver (block CG, LOBPCG) or a FEM
code with several load cases does. `counts["calls"]` counts column
products, B a block call, so every rate reader reads 2 nnz(A) a
product; the traced window's work is the block call's (2 nnz B
operations; A's values once, X read once and Y written once: 4 (nnz +
2 n B) bytes), built here. A seeded uniform sample of `sample` block
calls is kept and judged after the window, column by column, against
the float64 product on the original matrix, mapped back through the
port's permutation: the worst `rel_l2`, and each column past the limit
a failure. In a control run (`run.control`) the bfloat16 reference
takes the program's place and is judged by the same check."""

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


def block_work(n: int, nnz: int, B: int) -> roofline.Work:
    """Y = A X, A n x n, X and Y n x B: A's values once, X read once, Y
    written once."""
    return roofline.Work(2.0 * nnz * B, roofline.F32 * (nnz + 2 * n * B))


class Entry:
    def __init__(self, run, csr):
        self.run, self.csr = run, csr
        self.B = int(run.traffic["columns"])
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
        self.work = block_work(csr.n, csr.nnz, self.B)
        k = int(run.traffic["inputs"])
        gen = run.generator()
        self.X = torch.randn(k, csr.n, self.B, generator=gen,
                             device=gen.device)
        self.xs = [self.X[i].index_select(0, self.perm).contiguous()
                   for i in range(k)]
        for X in self.xs:
            self.fn(self.layout, X)
        run.sync()

    def _build(self):
        """The program's route; returns its permutation."""
        from tpu_spmv_torch.formats.csr import CSRMatrix
        from tpu_spmv_torch.tools.spmm import build_spmm
        from tpu_spmv_torch.tools.spmv import prepare

        run, csr = self.run, self.csr
        mat = CSRMatrix(csr.indptr, csr.indices, csr.data, (csr.n, csr.n))
        with run.span("build.prepare"):
            ck, perm = prepare(mat, run.config["rcm"])
        with run.span("build.layout"):
            self.layout, self.fn, passes = build_spmm(
                ck.matrix, "auto", self.B, device=run.device)
            run.sync()
        run.notes["kernel"] = getattr(self.fn, "__name__", "spmm")
        run.notes["layout"] = type(self.layout).__name__
        run.notes["column_passes"] = passes
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
            Y = fn(layout, xs[i % k])
            if i == nxt:
                nxt = take(i, (i % k, Y))
            i += 1
            if time.perf_counter() >= end:
                break
        self.run.sync()
        self.run.window_s = time.perf_counter() - t0
        self.run.counts["calls"] = i * self.B
        self.run.counts["block_calls"] = i

    def issue(self) -> None:
        """Host seconds to issue one block call, from bursts short enough
        that the launch queue never fills, each after a synchronize."""
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
        n, B = self.csr.n, self.B
        ref = ref_spmv.products(
            self.csr, self.X.permute(0, 2, 1).reshape(-1, n))
        limit = self.run.limits["rel_l2"]
        worst, wrong = 0.0, 0
        for k, Y in samples:
            Y_orig = torch.empty_like(Y)
            Y_orig[self.perm] = Y
            for j in range(B):
                err = rel_l2(Y_orig[:, j], ref[k * B + j])
                if math.isnan(err) or err > worst:
                    worst = err
                wrong += not err <= limit
        return {"rel_l2": worst}, wrong
