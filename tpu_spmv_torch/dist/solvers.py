"""CG and Jacobi-PCG over the sharded SpMV: the port of
`tpu_spmv/dist/solvers.py`.

Vectors are sharded as the SpMV's (lists of D row pieces, one per mesh
device, None for a shard of another process). A dot product is the sum
of the shards' partial dots in shard order (the reference's psum; across
processes the D partials are all-gathered first, so every process adds
the same terms in the same order as one process does), left on the
device: no `.item()` and no Python branch on a device value, so one
iteration can be captured in a CUDA graph (`capture_step`) and
replayed, the counterpart of the reference's jitted loop. The state is
the reference's tuple (x, r, p, rz), with the same `max(., 1e-30)`
guards. On the CPU, and under a gloo process group (whose collectives
are host calls), the loop runs eagerly.

On the card a CG iteration over a ShardedRanked layout is three
hand-written kernels a shard (kernels/cg.py, `fused`): the ranked walk
with a p.Ap epilogue, the updates of x and r with r.r, and the new p
with rz; they advance the state in place, so a captured iteration
copies nothing back. Across processes the shards' partial dots are
all-gathered between them, as `_dot` gathers them. Elsewhere (the CPU,
ShardedSell, OverlapRanked, a gloo group, plain=True) the step is the
composed one below, torch's vector operations around the sharded SpMV:
the fused kernels' plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_spmv_torch import obs
from tpu_spmv_torch.dist import group
from tpu_spmv_torch.dist.sharding import (
    OverlapRanked, RowMesh, ShardedRanked, each, sharded_call, spmv_overlap,
    spmv_sharded,
)
from tpu_spmv_torch.kernels import _build
from tpu_spmv_torch.kernels import cg as cg_kernels


def _spmv_any(layout, v, mesh: RowMesh, axis="rows", plain=False):
    """spmv_overlap for an OverlapRanked layout, else spmv_sharded."""
    if isinstance(layout, OverlapRanked):
        return spmv_overlap(layout, v, mesh, axis, plain)
    return spmv_sharded(layout, v, mesh, axis, plain)


def _dot(a, b, mesh: RowMesh) -> torch.Tensor:
    """Sum of the shards' dots, on this process's first shard's device,
    shard by shard in order (one shard's dot is the sum, with no extra
    launch). Across processes the D partial dots are all-gathered over
    the group and summed in the same order on every process: the bits of
    the one-process sum."""
    home = mesh.home
    parts = [torch.dot(x, y).to(home, non_blocking=True)
             for x, y in zip(a, b) if x is not None]
    if mesh.world > 1:
        parts = list(group.all_gather_rows(mesh, torch.stack(parts)))
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def _axpy(y, s: torch.Tensor, x, sign: float = 1.0) -> list:
    """[y_d + sign * s * x_d] shard by shard, one launch a shard; s a
    device scalar, moved to each shard's device."""
    return each(lambda yi, xi: torch.addcmul(
        yi, s.to(yi.device, non_blocking=True), xi, value=sign), y, x)


def fused(layout, mesh: RowMesh, plain: bool = False) -> bool:
    """Whether cg_step runs the fused kernels (kernels/cg.py): a
    ShardedRanked layout, not plain, and this process's shards on one
    CUDA card with no gloo group (graph_default's mesh)."""
    return (not plain and isinstance(layout, ShardedRanked)
            and graph_default(mesh))


def cg_step(layout, mesh: RowMesh, state, axis="rows", plain=False,
            scratch=None):
    """One CG iteration on the sharded state (x, r, p, rz). layout:
    ShardedSell, ShardedRanked or OverlapRanked. Where `fused` holds, the
    fused kernels advance the state in place and return it, on `scratch`
    (fused_scratch; made for this call if None); elsewhere the composed
    step returns a new state (through the SpMV kernels' plain versions
    with plain=True)."""
    if fused(layout, mesh, plain):
        if scratch is None:
            scratch = fused_scratch(layout, mesh)
        return _fused_step(layout, mesh, state, axis, scratch)
    x, r, p, rz = state
    Ap = _spmv_any(layout, p, mesh, axis, plain)
    alpha = rz / torch.clamp_min(_dot(p, Ap, mesh), 1e-30)
    x = _axpy(x, alpha, p)
    r = _axpy(r, alpha, Ap, -1.0)
    rz_new = _dot(r, r, mesh)
    beta = rz_new / torch.clamp_min(rz, 1e-30)
    p = _axpy(r, beta, p)
    return (x, r, p, rz_new)


def fused_scratch(layout: ShardedRanked, mesh: RowMesh):
    """The fused step's device scratch: each local shard's CGScratch
    (its done counters 0) and the (2, D) slots of the shards' p.Ap and
    r.r on this process's card. A captured iteration reads the same
    memory at every replay, so whoever captures one makes its own."""
    return ([None if mesh.devices[d] is None
             else cg_kernels.CGScratch(layout.shards[d], mesh.devices[d])
             for d in range(mesh.size)],
            torch.zeros(2, mesh.size, dtype=torch.float32, device=mesh.home))


def _all_partials(row: torch.Tensor, mesh: RowMesh) -> torch.Tensor:
    """The D shards' partials of one dot in shard order: `row` (D slots)
    in one process; across processes each one's own slots, all-gathered
    over the group (in rank order, shards hosts-major: shard order)."""
    if mesh.world == 1:
        return row
    return group.all_gather_rows(mesh, row[mesh.local[0]:mesh.local[-1] + 1])


def _fused_step(layout: ShardedRanked, mesh: RowMesh, state, axis,
                scratch):
    """cg_step's three kernels a shard, in place, on `scratch`
    (fused_scratch): K1 on the shards' streams (spmv_sharded's exchange),
    then K2 and K3 of every shard on the caller's stream, each after the
    dot its alpha or beta needs."""
    x, r, p, rz = state
    held, dots = scratch
    Ap = sharded_call(layout, p, mesh, lambda d, lay, win: (
        cg_kernels.spmv_ranked_dot(lay, win, p[d], held[d],
                                   dots[0, d:d + 1])), axis)
    pap = _all_partials(dots[0], mesh)
    for d in mesh.local:
        cg_kernels.cg_update(pap, rz, p[d], Ap[d], x[d], r[d], held[d],
                             dots[1, d:d + 1])
    rr = _all_partials(dots[1], mesh)
    for d in mesh.local:
        cg_kernels.cg_direction(rr, rz, r[d], p[d],
                                held[d] if d == mesh.local[-1] else None)
    return state


def pcg_step(layout, mesh: RowMesh, inv_diag, state, axis="rows"):
    """One Jacobi-PCG iteration: z = r * inv_diag, shard by shard (the
    preconditioner needs no exchange)."""
    x, r, p, rz = state
    Ap = _spmv_any(layout, p, mesh, axis)
    alpha = rz / torch.clamp_min(_dot(p, Ap, mesh), 1e-30)
    x = _axpy(x, alpha, p)
    r = _axpy(r, alpha, Ap, -1.0)
    z = each(torch.mul, r, inv_diag)
    rz_new = _dot(r, z, mesh)
    beta = rz_new / torch.clamp_min(rz, 1e-30)
    p = _axpy(z, beta, p)
    return (x, r, p, rz_new)


def cg_init(b, mesh: RowMesh):
    """CG state before the first iteration: x = 0, r = p = b."""
    return (each(torch.zeros_like, b), each(torch.clone, b),
            each(torch.clone, b), _dot(b, b, mesh))


def pcg_init(b, mesh: RowMesh, inv_diag):
    """Jacobi-PCG state before the first iteration: z = b * inv_diag."""
    z = each(torch.mul, b, inv_diag)
    return (each(torch.zeros_like, b), each(torch.clone, b), z,
            _dot(b, z, mesh))


def _step_fn(layout, mesh, inv_diag, axis):
    """The iteration as a function of the state, and the counters of
    the shards it fuses: `cg.fused_shards` (this process's shards on the
    fused kernels, which the function's own scratch serves; 0 for the
    composed step and for Jacobi-PCG) of `cg.local_shards`."""
    on = inv_diag is None and fused(layout, mesh)
    obs.set_counters({"cg.fused_shards": len(mesh.local) if on else 0,
                      "cg.local_shards": len(mesh.local)})
    if inv_diag is None:
        scratch = fused_scratch(layout, mesh) if on else None
        return lambda s: cg_step(layout, mesh, s, axis, scratch=scratch)
    return lambda s: pcg_step(layout, mesh, inv_diag, s, axis)


def graph_default(mesh: RowMesh) -> bool:
    """Whether an iteration is captured by default: this process's shards
    share one card, and any process group is NCCL (gloo's collectives
    are host calls, which no graph holds)."""
    devices = {mesh.devices[d] for d in mesh.local}
    return (len(devices) == 1 and next(iter(devices)).type == "cuda"
            and mesh.backend in (None, "nccl"))


def capture(step, mesh: RowMesh, state):
    """A CUDA graph of step(state) that advances `state` (a tuple of
    lists of shards and device scalars, on the card) in place at each
    replay. This process's shards must share one card: the graph is
    captured on it (its shard streams fork from the capture and join it
    again); across processes each captures its own, over NCCL. One step
    runs eagerly first on copies, so the state is untouched, to warm the
    kernels and start the group's communicators before capture. The
    kernel library is loaded first, as its own phase (build.kernels);
    the rest is the phase build.capture."""
    if not graph_default(mesh):
        raise ValueError(
            "a captured iteration needs this process's shards on one CUDA "
            "card and no gloo group; the mesh spans "
            f"{sorted(str(mesh.devices[d]) for d in mesh.local)}, backend "
            f"{mesh.backend}")
    _build.library()
    with obs.span("build.capture"):
        return _capture(step, state)


def _capture(step, state):
    def copies(st):
        return tuple(each(torch.clone, v) if isinstance(v, list)
                     else v.clone() for v in st)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(copies(state))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        new = step(state)
        if new is not state:  # a step in place (the fused one) copies none
            for old, upd in zip(state, new):
                if isinstance(old, list):
                    each(torch.Tensor.copy_, old, upd)
                else:
                    old.copy_(upd)
    return graph


def capture_step(layout, mesh: RowMesh, state, inv_diag=None, axis="rows"):
    """A CUDA graph of one iteration (CG, or Jacobi-PCG with inv_diag)
    that advances `state` (from cg_init / pcg_init, on the card) in place
    at each replay (see capture)."""
    return capture(_step_fn(layout, mesh, inv_diag, axis), mesh, state)


def _run(layout, b, mesh, iters, inv_diag, axis, graph):
    state = cg_init(b, mesh) if inv_diag is None else pcg_init(
        b, mesh, inv_diag)
    if graph is None:
        graph = graph_default(mesh)
    if graph and iters > 0:
        g = capture_step(layout, mesh, state, inv_diag, axis)
        for _ in range(iters):
            g.replay()
    else:
        step = _step_fn(layout, mesh, inv_diag, axis)
        for _ in range(iters):
            state = step(state)
    return state[0], state[3]


def cg_solve(layout, b, mesh: RowMesh, iters: int = 50, axis="rows",
             graph: bool | None = None):
    """Solve A x = b (A SPD) with `iters` fixed CG iterations. b: the
    sharded right-hand side (padded_m rows in D shards). Returns (x
    sharded, final residual norm^2 as a device scalar). graph: replay a
    captured iteration (default: graph_default)."""
    return _run(layout, b, mesh, iters, None, axis, graph)


def pcg_solve(layout, b, mesh: RowMesh, inv_diag, iters: int = 50,
              axis="rows", graph: bool | None = None):
    """Jacobi-preconditioned CG: M^-1 = diag(A)^-1 applied row by row.
    inv_diag: sharded as b, zeros on padding rows. Returns (x, final
    r.z)."""
    return _run(layout, b, mesh, iters, inv_diag, axis, graph)


def jacobi_inv_diag(diag, padded_m: int):
    """The reference's Jacobi scaling (tpu_spmv/tools/solve.py): the
    signed reciprocal of the diagonal, 1 where it is 0 (identity on a
    row without a diagonal entry), 0 on padding rows; a host array."""
    diag = np.asarray(diag, np.float32)
    inv = np.zeros(padded_m, np.float32)
    inv[: diag.shape[0]] = np.where(
        diag != 0, 1.0 / np.where(diag != 0, diag, 1.0), 1.0)
    return inv


__all__ = [
    "capture", "capture_step", "cg_init", "cg_solve", "cg_step", "fused",
    "fused_scratch", "graph_default", "jacobi_inv_diag", "pcg_init",
    "pcg_solve", "pcg_step",
]
