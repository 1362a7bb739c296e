"""CG solves of A x = b over a process group, one card a process: the
route the port takes across processes. Each rank starts the port's
group (`multihost.initialize`, from the variables spmv_bench/ranks.py
gives it: NCCL on the cards, gloo on the CPU), plans and orders the
global matrix as entries/solve.py does, builds the host layouts of
every shard (`ShardedRanked.build(mat, P)`), places its own
(`device_put` on `make_hybrid_mesh()`, one shard a process) and
captures one CG iteration over the group (`capture_step`): the halo
rows cross between processes in one batch of sends and receives
(`_remote_halos`), and each dot all-gathers the shards' partials.

Traffic and check as entries/solve.py's (precond "none" only), over the
group. Every rank runs the same solves, which stop at the same
iteration: rz holds the same bits on every rank. After each solve the
ranks all-gather one integer, whether to go on, and take rank 0's,
whose clock holds the window (`agree`): a broadcast that also waits for
every rank, outside the captured iteration. The right-hand sides stay
on the host; each rank places its own rows of each (`shard_vector`),
and a solve starts from the program's `cg_init`, copied into the
captured state. A sampled x is kept as each rank's shard and gathered
(`gather_vector`, on every rank) after the window and the `extra`
solves; then every rank frees the program's state and leaves the group,
and rank 0 alone judges each x against the float64 solution on its own
card (reference.cg.solve_many: every b in one CG). The ranks' memory
peaks, read before the extra solves as on one card, are all-gathered
for rank 0's line. A control run (`run.control`) starts no group and is
entries/solve.py's: the bfloat16 reference on rank 0's card over the
global operator.

The roofline of `traced` counts rank 0's own share of the work: its
rows and their nonzeros. `counts["exchange_bytes"]` is what rank 0
sends plus receives in one SpMV's exchange, from the placed layout: its
halo rows, both ways, at each boundary with another process's shard;
the whole padded x where the layout gathers x instead."""

from __future__ import annotations

import functools
import math

import torch

from spmv_bench import roofline
from spmv_bench.entries import solve
from spmv_bench.reference import cg as ref_cg, rel_l2


class Entry(solve.Entry):
    mesh = None

    def rhs_device(self):
        return self.run.device if self.run.control else torch.device("cpu")

    def agree(self, go_on: bool) -> bool:
        if self.mesh is None:
            return go_on
        from tpu_spmv_torch.dist import group

        flag = torch.tensor([int(go_on)], dtype=torch.int32,
                            device=self.mesh.home)
        return bool(group.all_gather_rows(self.mesh, flag)[0])

    def _program(self, precond):
        from tpu_spmv_torch.dist import multihost

        run = self.run
        if precond != "none" or run.processes < 2:
            raise SystemExit("solve_group runs CG (precond none) over two "
                             f"processes or more, not {precond!r} over "
                             f"{run.processes}")
        with run.span("group.start"):
            multihost.initialize(device=run.device)
        run.notes["processes"] = multihost.process_count()
        run.notes["backend"] = multihost.backend()
        super()._program(precond)

    def _cg(self, mat):
        from tpu_spmv_torch.dist.multihost import make_hybrid_mesh, row_spec
        from tpu_spmv_torch.dist.sharding import ShardedRanked, shard_vector
        from tpu_spmv_torch.dist.solvers import capture_step, cg_init, cg_step

        run, axis = self.run, row_spec()
        with run.span("build.layout"):
            mesh = make_hybrid_mesh(devices=[run.device])
            lay = ShardedRanked.build(mat, mesh.size).device_put(mesh, axis)
            run.sync()
        (d,) = mesh.local
        perm = self.perm.cpu()
        self.prep = lambda b: shard_vector(
            b.index_select(0, perm).numpy(), mesh, lay.padded_m)
        self.state = cg_init(self.prep(self.b[0]), mesh)

        def reset(b):
            for old, new in zip(self.state, cg_init(b, mesh)):
                (old[d] if isinstance(old, list) else old).copy_(
                    new[d] if isinstance(new, list) else new)

        self._start(reset, lambda st: cg_step(lay, mesh, st, axis=axis),
                    functools.partial(capture_step, axis=axis), (lay, mesh))
        self.mesh, self.shard = mesh, d
        self.x = lambda: self.state[0][d]

        r0 = min(d * lay.rows_per_shard, mat.shape[0])
        r1 = min(r0 + lay.rows_per_shard, mat.shape[0])
        nnz = int(mat.indptr[r1]) - int(mat.indptr[r0])
        self.iter_work = roofline.cg_iteration(r1 - r0, nnz)
        self.start_work = roofline.cg_start(r1 - r0)
        x_bytes = self.state[0][d].element_size()
        if lay.halo:
            sides = sum(0 <= e < mesh.size and mesh.owner(e) != mesh.rank
                        for e in (d - 1, d + 1))
            run.counts["exchange_bytes"] = 2 * lay.halo * x_bytes * sides
        else:
            run.counts["exchange_bytes"] = lay.padded_m * x_bytes

    def check(self):
        if self.mesh is None:
            return super().check()
        import torch.distributed as dist

        from tpu_spmv_torch.dist import group
        from tpu_spmv_torch.dist.sharding import gather_vector

        run, mesh = self.run, self.mesh
        kept, bs = list(self.sample.items), list(self.b)
        failed = run.counts["failed_solves"]
        for b in solve.extra_rhs(self.csr, int(run.traffic["extra"]),
                                 run.seed, self.rhs_device()):
            ok, _ = self.solve(self.prep(b))
            failed += not ok
            kept.append((len(bs), self.x().clone()))
            bs.append(b)
        peaks = group.all_gather_rows(mesh, torch.tensor(
            [run.memory_peak_bytes], dtype=torch.int64, device=mesh.home))
        xs = [(k, gather_vector([x if e == self.shard else None
                                 for e in range(mesh.size)], mesh))
              for k, x in kept]
        del self.state, self.step, self.reset, self.x, self.held, self.prep
        del kept
        if run.device.type == "cuda":
            torch.cuda.empty_cache()
        # Every rank has freed the program's state before rank 0 judges.
        group.all_gather_rows(mesh, peaks[:1])
        self.mesh = None
        dist.destroy_process_group()
        if run.rank:
            return {}, 0
        run.memory_peak_bytes = int(peaks.max())
        run.notes["memory_peak_bytes_by_rank"] = peaks.tolist()
        n, limit = self.csr.n, run.limits["rel_err"]
        ks = sorted({k for k, _ in xs})
        refs = dict(zip(ks, ref_cg.solve_many(
            self.csr, torch.stack([bs[k] for k in ks]).to(run.device))))
        worst, wrong = 0.0, 0
        for k, x in xs:
            x = torch.from_numpy(x[:n]).to(run.device)
            x_orig = torch.empty_like(x)
            x_orig[self.perm] = x
            err = rel_l2(x_orig, refs[k])
            if math.isnan(err) or err > worst:
                worst = err
            wrong += not err <= limit
        return {"rel_err": worst, "failed_solves": failed}, wrong + failed
