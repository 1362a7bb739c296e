"""IC(0)-preconditioned CG on one device (the single-device half of
`tpu_spmv/sts/ic0.py`).

IC(0) is the incomplete Cholesky factor L on the lower pattern of an SPD
matrix, with no fill; M^-1 = (L L^T)^-1 is applied as one forward solve
on L and one on the row+column reversal of L^T (a lower system again,
sts/host.reversed_for_upper), both through `lower_solve`. Both systems
use level order with sort_packs=False, which keeps a triangular input's
structure (the two `raise`s below guard it).

The factorization is the reference's native routine (the port's copy,
`tpu_spmv_torch.reorder.native.ic0`), or a copy of its NumPy twin when the
native core is missing; the factor is bit-equal either way.

`pcg_ic0_step` is the reference's jitted loop body: one `spmv_ranked`,
two triangular solves, the same `max(., 1e-30)` guards, and no host
round trip (no `.item()`, no Python branch on a device value), so
`capture_pcg_step` can record one iteration in a CUDA graph, the
counterpart of the JAX loop's jit.

Over D row shards (dist/), two preconditioners, each holding the
reference's arrays equal array for array:

  ShardedIC0Preconditioner      exact IC(0): each application is two
                                block forward substitutions
                                (dist/sts.sts_solve_sharded), threaded
                                through the reference's five index maps;
                                the maps cross shards, so the sharded
                                vectors are joined on the first shard's
                                device for the gathers (on one card a
                                view or one torch.cat);
  BlockJacobiIC0Preconditioner  one IC(0) factor a shard, on its
                                diagonal block: each shard's two
                                `lower_solve_blocks` run on its own
                                stream, with no communication.

`pcg_ic0_sharded` runs PCG over dist.spmv_sharded with either, with the
dot products and updates of dist/solvers.py;
`capture_pcg_sharded_step` records one iteration in a CUDA graph when
the shards share a card.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from tpu_spmv_torch import obs
from tpu_spmv_torch.formats.csr import CSRMatrix
from tpu_spmv_torch.formats.sell import LANES, TensorLayout
from tpu_spmv_torch.hw import target_device
from tpu_spmv_torch.sts.host import build_sts, reversed_for_upper, split_lu
from tpu_spmv_torch.sts.solve import LowerSolveLayout, _with_waits, lower_solve


def _ic0_numpy(indptr, indices, data):
    """NumPy IC(0), exact-parity with cpp/reorder.cc tpu_spmv_ic0
    (f32 storage, f64 accumulation, same breakdown shift); a copy of
    tpu_spmv.sts.ic0._ic0_numpy."""
    m = indptr.shape[0] - 1
    out = np.array(data, dtype=np.float32, copy=True)
    bad = 0
    for i in range(m):
        i0, i1 = int(indptr[i]), int(indptr[i + 1])
        if i1 <= i0 or indices[i1 - 1] != i:
            raise ValueError(f"row {i}: diagonal must be the last entry")
        for idx in range(i0, i1 - 1):
            k = int(indices[idx])
            s = float(out[idx])
            a, b = i0, int(indptr[k])
            aend, bend = idx, int(indptr[k + 1]) - 1
            while a < aend and b < bend:
                ca, cb = indices[a], indices[b]
                if ca == cb:
                    s -= float(out[a]) * float(out[b])
                    a += 1
                    b += 1
                elif ca < cb:
                    a += 1
                else:
                    b += 1
            out[idx] = np.float32(s / float(out[indptr[k + 1] - 1]))
        s = float(out[i1 - 1])
        for idx in range(i0, i1 - 1):
            s -= float(out[idx]) ** 2
        if not s > 0.0:
            floor_ = max(1e-8 * abs(float(out[i1 - 1])), 1e-8)
            s = max(abs(s), floor_)
            bad += 1
        out[i1 - 1] = np.float32(np.sqrt(s))
    return out, bad


def ic0_factor(mat: CSRMatrix) -> tuple[CSRMatrix, int]:
    """IC(0) factor L (lower, diagonal included) of a symmetric
    positive-definite matrix, on the lower pattern of `mat`. Returns
    (L, breakdown count: 0 for diagonally dominant SPD inputs)."""
    lower, _ = split_lu(mat)
    from tpu_spmv_torch.reorder import native

    if native.available():
        vals, bad = native.ic0(lower.indptr, lower.indices, lower.data)
    else:
        vals, bad = _ic0_numpy(lower.indptr, lower.indices, lower.data)
    return CSRMatrix(lower.indptr, lower.indices, vals, lower.shape), bad


def _build_ic0_systems(mat: CSRMatrix):
    """Factor (phase build.ic0.factor) and the two solve systems' level
    schedules (build.ic0.schedule). Returns (L, breakdowns, sys_l, inv_l,
    rev, sys_u, inv_u)."""
    with obs.span("build.ic0.factor"):
        L, bad = ic0_factor(mat)
    with obs.span("build.ic0.schedule"):
        return (L, bad, *_ic0_schedules(L))


def _ic0_schedules(L: CSRMatrix):
    """The LS schedules of L and of the reversed L^T: (sys_l, inv_l,
    rev, sys_u, inv_u)."""
    import scipy.sparse as sp

    sys_l = build_sts(L, order_type="LS", sort_packs=False)
    if sys_l.lower.nnz != L.nnz:
        # nnz leaked to the upper split: the schedule did not keep L's
        # triangular structure, and M^-1 would be another operator.
        raise ValueError("LS schedule failed to preserve L's structure")
    inv_l = np.argsort(sys_l.perm)

    U = CSRMatrix.from_scipy(sp.csr_matrix(L.to_scipy().T))
    mat_ru, rev = reversed_for_upper(U)
    sys_u = build_sts(mat_ru, order_type="LS", sort_packs=False)
    if sys_u.lower.nnz != U.nnz:
        raise ValueError("LS schedule failed to preserve U's structure")
    inv_u = np.argsort(sys_u.perm)
    return sys_l, inv_l, rev, sys_u, inv_u


def _scatter_b(layout: LowerSolveLayout, b: torch.Tensor) -> torch.Tensor:
    """b (m,) in the layout's system order -> scaled padded blocks."""
    flat = torch.zeros(layout.inv_diag.numel(), dtype=torch.float32,
                       device=b.device)
    flat.index_put_((layout.pad_index,), b)
    return flat.view(layout.inv_diag.shape) * layout.inv_diag


@dataclasses.dataclass
class IC0Preconditioner(TensorLayout):
    """M^-1 = (L L^T)^-1 as two chunk-ordered solves.

    lay_l / lay_u: solve layouts for L and for the reversed L^T.
    idx0/idx1/idx2: the composed gather maps that thread the two
    systems' permutations: r -> b_L, y_sys -> b_U, x_sys -> z.
    """

    lay_l: LowerSolveLayout
    lay_u: LowerSolveLayout
    idx0: torch.Tensor
    idx1: torch.Tensor
    idx2: torch.Tensor
    breakdowns: int = 0

    @classmethod
    def build(cls, mat: CSRMatrix, device=None) -> "IC0Preconditioner":
        """Factor and both solve layouts, on `device` (default: the
        card; raises without one, hw.target_device)."""
        device = target_device(device)
        L, bad, sys_l, inv_l, rev, sys_u, inv_u = _build_ic0_systems(mat)
        b_dummy = np.zeros(L.m, np.float32)
        with obs.span("build.ic0.layout"):
            lay_l = LowerSolveLayout.build(sys_l, b_dummy, device=device)
            lay_u = LowerSolveLayout.build(sys_u, b_dummy, device=device)
        return cls(
            lay_l=lay_l,
            lay_u=lay_u,
            idx0=torch.from_numpy(np.asarray(sys_l.perm, np.int64)),
            idx1=torch.from_numpy(inv_l[rev[sys_u.perm]].astype(np.int64)),
            idx2=torch.from_numpy(inv_u[rev].astype(np.int64)),
            breakdowns=bad,
        ).to(device)

    def apply(self, r: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """z = (L L^T)^-1 r, on r's device (two triangular solves;
        plain=True: their plain versions on any device)."""
        y_sys = lower_solve(
            self.lay_l, _scatter_b(self.lay_l, r.index_select(0, self.idx0)),
            plain,
        )
        x_sys = lower_solve(
            self.lay_u,
            _scatter_b(self.lay_u, y_sys.index_select(0, self.idx1)), plain,
        )
        return x_sys.index_select(0, self.idx2)


def pcg_ic0_init(b: torch.Tensor, precond: IC0Preconditioner):
    """PCG state (x, r, p, rz) before the first iteration."""
    z0 = precond.apply(b)
    return torch.zeros_like(b), b.clone(), z0, torch.dot(b, z0)


def pcg_ic0_step(layout, precond: IC0Preconditioner, state):
    """One PCG iteration: one spmv_ranked, two triangular solves."""
    from tpu_spmv_torch.kernels.sell import spmv_ranked

    x, r, p, rz = state
    Ap = spmv_ranked(layout, p)
    alpha = rz / torch.clamp_min(torch.dot(p, Ap), 1e-30)
    x = x + alpha * p
    r = r - alpha * Ap
    z = precond.apply(r)
    rz_new = torch.dot(r, z)
    beta = rz_new / torch.clamp_min(rz, 1e-30)
    p = z + beta * p
    return x, r, p, rz_new


def pcg_ic0_solve(layout, b: torch.Tensor, precond: IC0Preconditioner,
                  iters: int = 50):
    """PCG with the IC(0) preconditioner on b's device. layout: the
    matrix as RankedSlabs. Returns (x, final r.z)."""
    state = pcg_ic0_init(b, precond)
    for _ in range(iters):
        state = pcg_ic0_step(layout, precond, state)
    return state[0], state[3]


def capture_pcg_step(layout, precond: IC0Preconditioner, state):
    """A CUDA graph of one PCG iteration that advances `state` (a tuple
    of CUDA tensors (x, r, p, rz), e.g. from pcg_ic0_init) in place at
    every replay. One iteration runs eagerly on a side stream first (on
    copies, so state is untouched) to warm the kernels and set up cuBLAS
    before capture (dist/solvers._capture). The kernel library is loaded
    first, as its own phase (build.kernels); the rest is the phase
    build.capture."""
    from tpu_spmv_torch.dist.solvers import _capture
    from tpu_spmv_torch.kernels import _build

    _build.library()
    with obs.span("build.capture"):
        return _capture(lambda st: pcg_ic0_step(layout, precond, st), state)


def _joined(xs, mesh) -> torch.Tensor:
    """A sharded vector as one vector on this process's first shard's
    device (one torch.cat; across processes an all-gather over the
    group)."""
    from tpu_spmv_torch.dist import group

    local = torch.cat([t.to(mesh.home, non_blocking=True) for t in xs
                       if t is not None])
    return local if mesh.world == 1 else group.all_gather_rows(mesh, local)


def _split(v: torch.Tensor, mesh, rows: int) -> list:
    """One vector cut into mesh.size shards of `rows` rows, shard d on
    mesh.devices[d] (views where it already lies there; None for a shard
    of another process)."""
    return [None if dev is None else
            v[d * rows:(d + 1) * rows].to(dev, non_blocking=True)
            for d, dev in enumerate(mesh.devices)]


@dataclasses.dataclass
class ShardedIC0Preconditioner:
    """Exact IC(0) over D shards: M^-1 r by two block forward
    substitution chains (dist/sts.py) an application. The five index
    maps (the reference's, int64 here) thread the A-space sharded
    vectors through the two solve systems' pack paddings and
    permutations, as IC0Preconditioner's do on one device. Across
    processes each process gathers r whole, runs both chains (every
    process receives every step's rows, dist/sts.py) and keeps its own
    rows of z."""

    lay_l: object  # dist.sts.ShardedLowerSolve for L
    lay_u: object  # ... for the reversed L^T
    bl_gather: torch.Tensor  # r[bl_gather] -> rows of L's rhs (m,)
    bl_scatter: torch.Tensor  # ... scattered to b_L_pad positions (m,)
    bu_gather: torch.Tensor  # x_L_pad[bu_gather] -> rows of U's rhs (m,)
    bu_scatter: torch.Tensor  # ... scattered to b_U_pad positions (m,)
    z_gather: torch.Tensor  # x_U_pad[z_gather] -> z rows (m,)
    m: int
    padded_m_a: int  # the SpMV layout's padded length (z re-padding)
    breakdowns: int = 0

    def device_put(self, mesh, axis="rows") -> "ShardedIC0Preconditioner":
        """Both solve layouts placed shard by shard; the maps, which feed
        gathers across shards, on this process's first shard's device."""
        home = mesh.home
        maps = {k: getattr(self, k).to(home) for k in (
            "bl_gather", "bl_scatter", "bu_gather", "bu_scatter", "z_gather")}
        return dataclasses.replace(
            self, lay_l=self.lay_l.device_put(mesh, axis),
            lay_u=self.lay_u.device_put(mesh, axis), **maps)

    @classmethod
    def build(cls, mat: CSRMatrix, n_devices: int,
              padded_m_a: int) -> "ShardedIC0Preconditioner":
        """Factor and both sharded solve layouts, on the host
        (device_put places them)."""
        from tpu_spmv_torch.dist.sts import ShardedLowerSolve

        L, bad, sys_l, inv_l, rev, sys_u, inv_u = _build_ic0_systems(mat)
        m = L.m
        zeros = np.zeros(m, np.float32)
        lay_l, pad_l = ShardedLowerSolve.build(sys_l, zeros, n_devices)
        lay_u, pad_u = ShardedLowerSolve.build(sys_u, zeros, n_devices)

        def i64(a):
            return torch.from_numpy(np.asarray(a, np.int64))

        return cls(
            lay_l=lay_l,
            lay_u=lay_u,
            # b_L_pad[pad_l[t]] = r[perm_l[t]]
            bl_gather=i64(sys_l.perm),
            bl_scatter=i64(pad_l),
            # b_U_pad[pad_u[t]] = y[rev[perm_u[t]]]
            #                   = x_L_pad[pad_l[inv_l[rev[perm_u[t]]]]]
            bu_gather=i64(pad_l[inv_l[rev[sys_u.perm]]]),
            bu_scatter=i64(pad_u),
            # z[j] = x_U_pad[pad_u[inv_u[rev[j]]]]
            z_gather=i64(pad_u[inv_u[rev]]),
            m=m,
            padded_m_a=padded_m_a,
            breakdowns=bad,
        )

    def _solve(self, lay, b_full, mesh, plain) -> torch.Tensor:
        """x (padded_m,) of one chain, on this process's first shard's
        device."""
        from tpu_spmv_torch.dist.sts import solve_whole

        return solve_whole(lay, mesh, _split(b_full, mesh,
                                             lay.rows_per_shard), plain)

    def apply(self, r, mesh, axis="rows", plain: bool = False) -> list:
        """z = (L L^T)^-1 r. r: D shards of the A-space padded vector
        (padded_m_a rows in all); returns z sharded the same way (rows
        past m zero). plain=True runs the kernels' plain versions."""
        from tpu_spmv_torch.dist.sharding import _check_mesh

        _check_mesh(self.lay_l, mesh, axis)
        home = mesh.home
        b_l = torch.zeros(self.lay_l.padded_m, dtype=torch.float32,
                          device=home)
        b_l.index_put_((self.bl_scatter,),
                       _joined(r, mesh).index_select(0, self.bl_gather))
        x_l = self._solve(self.lay_l, b_l, mesh, plain)
        b_u = torch.zeros(self.lay_u.padded_m, dtype=torch.float32,
                          device=home)
        b_u.index_put_((self.bu_scatter,), x_l.index_select(0, self.bu_gather))
        x_u = self._solve(self.lay_u, b_u, mesh, plain)
        z = torch.zeros(self.padded_m_a, dtype=torch.float32, device=home)
        torch.index_select(x_u, 0, self.z_gather, out=z[: self.m])
        return _split(z, mesh, self.padded_m_a // mesh.size)


def _local_blocks_solves(stack, pack_ptrs, nc: int, max_nb: int):
    """Each shard's strict-L SellSlabs of a block-Jacobi stage, with its
    wait table, and the plain version's step tables."""
    from tpu_spmv_torch.dist.sharding import local_sell
    from tpu_spmv_torch.dist.sts import local_steps

    slabs, steps = [], []
    for d in range(int(stack[0].shape[0])):
        s = _with_waits(local_sell(stack, d, nc * LANES, nc * LANES, nc,
                                   max_nb))
        slabs.append(s)
        steps.append(local_steps(s.chunk_ptr, None if pack_ptrs is None
                                 else pack_ptrs[d], 0, nc))
    return slabs, steps


@dataclasses.dataclass
class BlockJacobiIC0Preconditioner:
    """Block-Jacobi IC(0): M = blockdiag(L_d L_d^T), one IC(0) factor a
    row shard on its diagonal block A_dd (a principal submatrix of an SPD
    matrix, so SPD), applied with two chunk-ordered solves a shard and no
    communication; it weakens as D grows (the coupling between blocks is
    dropped). The per-shard solve layouts are stacked on a leading axis
    of D as the reference stacks them (host tensors, equal to its arrays;
    each shard's blocks layout, ranked=False, and a 1x1 identity for an
    all-padding shard), with the port's containers a shard; the gather
    maps g_l, g_u and g_z thread the local residual through each shard's
    paddings and permutations, their out-of-range defaults pointing at an
    appended zero slot. l_pack_ptr / u_pack_ptr: each shard's pack chunk
    boundaries (None: the plain versions step chunk by chunk)."""

    lvals: torch.Tensor
    lcols: torch.Tensor
    lsub_b0: torch.Tensor
    lsub_nb: torch.Tensor
    lsub_chunk: torch.Tensor
    uvals: torch.Tensor
    ucols: torch.Tensor
    usub_b0: torch.Tensor
    usub_nb: torch.Tensor
    usub_chunk: torch.Tensor
    g_l: torch.Tensor  # (D, (nc_l+1)*128) r_ext -> b_L positions
    inv_l: torch.Tensor  # (D, (nc_l+1)*128) 1/diag(L_d) at pad positions
    g_u: torch.Tensor  # (D, (nc_u+1)*128) x_L_ext -> b_U positions
    inv_u: torch.Tensor  # (D, (nc_u+1)*128)
    g_z: torch.Tensor  # (D, rows_per_shard) x_U_ext -> local z rows
    m: int
    padded_m_a: int
    rows_per_shard: int
    nc_l: int
    nc_u: int
    l_max_nb: int
    u_max_nb: int
    n_devices: int
    breakdowns: int = 0
    l_pack_ptr: list = None
    u_pack_ptr: list = None
    local: list = None  # a dict a shard: slabs, steps and maps, placed

    def __post_init__(self):
        if self.local is not None:
            return
        lstack = (self.lvals, self.lcols, self.lsub_b0, self.lsub_nb,
                  self.lsub_chunk)
        ustack = (self.uvals, self.ucols, self.usub_b0, self.usub_nb,
                  self.usub_chunk)
        sl, stl = _local_blocks_solves(lstack, self.l_pack_ptr, self.nc_l,
                                       self.l_max_nb)
        su, stu = _local_blocks_solves(ustack, self.u_pack_ptr, self.nc_u,
                                       self.u_max_nb)
        self.local = [dict(
            slabs_l=sl[d], steps_l=stl[d], slabs_u=su[d], steps_u=stu[d],
            g_l=self.g_l[d], inv_l=self.inv_l[d], g_u=self.g_u[d],
            inv_u=self.inv_u[d], g_z=self.g_z[d],
        ) for d in range(self.n_devices)]

    def device_put(self, mesh, axis="rows") -> "BlockJacobiIC0Preconditioner":
        """This preconditioner with shard d's slabs and maps on
        mesh.devices[d] (None for a shard of another process)."""
        self._check(mesh, axis)
        out = copy.copy(self)
        out.local = [None if dev is None else {
            k: v if isinstance(v, np.ndarray) else v.to(dev)
            for k, v in loc.items()}
            for loc, dev in zip(self.local, mesh.devices)]
        return out

    def _check(self, mesh, axis) -> None:
        from tpu_spmv_torch.dist.sharding import mesh_axis_size

        if mesh_axis_size(mesh, axis) != self.n_devices:
            raise ValueError(
                f"preconditioner built for {self.n_devices} devices, "
                f"mesh axis {axis!r} spans "
                f"{mesh_axis_size(mesh, axis)} devices"
            )

    @classmethod
    def build(cls, mat: CSRMatrix, n_devices: int,
              padded_m_a: int) -> "BlockJacobiIC0Preconditioner":
        """One factor and two blocks solve layouts a shard, on the host
        (device_put places them)."""
        from tpu_spmv_torch.dist.sharding import stack_sell

        m = mat.m
        if padded_m_a % n_devices:
            raise ValueError("padded_m_a must divide evenly into shards")
        rows_per_shard = padded_m_a // n_devices
        sp_mat = mat.to_scipy().tocsr()

        per = []
        bad_total = 0
        for d in range(n_devices):
            r0 = min(d * rows_per_shard, m)
            r1 = min((d + 1) * rows_per_shard, m)
            m_loc = r1 - r0
            if m_loc == 0:
                # All-padding shard: a 1x1 identity keeps the stacked
                # shapes valid; the maps below never reference it.
                block = CSRMatrix(
                    np.array([0, 1], np.int32), np.array([0], np.int32),
                    np.array([1.0], np.float32), (1, 1),
                )
            else:
                block = CSRMatrix.from_scipy(sp_mat[r0:r1, r0:r1].tocsr())
            L, bad, sys_l, inv_lp, rev, sys_u, inv_up = _build_ic0_systems(
                block)
            bad_total += bad
            zeros = np.zeros(L.m, np.float32)
            lay_l = LowerSolveLayout.build(sys_l, zeros, ranked=False,
                                           device="cpu")
            lay_u = LowerSolveLayout.build(sys_u, zeros, ranked=False,
                                           device="cpu")
            per.append(dict(
                m_loc=m_loc,
                slabs_l=lay_l.slabs, slabs_u=lay_u.slabs,
                pack_l=lay_l.slab_steps[:, 0], pack_u=lay_u.slab_steps[:, 0],
                pad_l=lay_l.pad_index.numpy().astype(np.int64),
                pad_u=lay_u.pad_index.numpy().astype(np.int64),
                inv_l=lay_l.inv_diag.numpy().reshape(-1),
                inv_u=lay_u.inv_diag.numpy().reshape(-1),
                perm_l=np.asarray(sys_l.perm, np.int64),
                perm_u=np.asarray(sys_u.perm, np.int64),
                inv_lp=inv_lp, inv_up=inv_up, rev=rev,
            ))

        nc_l = max(p["slabs_l"].num_chunks for p in per)
        nc_u = max(p["slabs_u"].num_chunks for p in per)
        (lv, lc, lb0, lnb, lch), l_max_nb = stack_sell(
            [p["slabs_l"] for p in per], nc_l)
        (uv, uc, ub0, unb, uch), u_max_nb = stack_sell(
            [p["slabs_u"] for p in per], nc_u)

        size_l = (nc_l + 1) * LANES
        size_u = (nc_u + 1) * LANES
        D = n_devices
        g_l = np.full((D, size_l), rows_per_shard, np.int32)
        inv_l_st = np.zeros((D, size_l), np.float32)
        g_u = np.full((D, size_u), size_l, np.int32)
        inv_u_st = np.zeros((D, size_u), np.float32)
        g_z = np.full((D, rows_per_shard), size_u, np.int32)
        for d, p in enumerate(per):
            inv_l_st[d, : p["inv_l"].size] = p["inv_l"]
            inv_u_st[d, : p["inv_u"].size] = p["inv_u"]
            if p["m_loc"] == 0:
                continue
            # b_L_pad[pad_l[t]] = r_local[perm_l[t]]
            g_l[d, p["pad_l"]] = p["perm_l"]
            # b_U_pad[pad_u[t]] = x_L_pad[pad_l[inv_l[rev[perm_u[t]]]]]
            g_u[d, p["pad_u"]] = p["pad_l"][
                p["inv_lp"][p["rev"][p["perm_u"]]]]
            # z_local[j] = x_U_pad[pad_u[inv_u[rev[j]]]]
            g_z[d, : p["m_loc"]] = p["pad_u"][p["inv_up"][p["rev"]]]

        return cls(
            lvals=lv, lcols=lc, lsub_b0=lb0, lsub_nb=lnb, lsub_chunk=lch,
            uvals=uv, ucols=uc, usub_b0=ub0, usub_nb=unb, usub_chunk=uch,
            g_l=torch.from_numpy(g_l), inv_l=torch.from_numpy(inv_l_st),
            g_u=torch.from_numpy(g_u), inv_u=torch.from_numpy(inv_u_st),
            g_z=torch.from_numpy(g_z),
            m=m, padded_m_a=padded_m_a, rows_per_shard=rows_per_shard,
            nc_l=nc_l, nc_u=nc_u, l_max_nb=l_max_nb, u_max_nb=u_max_nb,
            n_devices=n_devices, breakdowns=bad_total,
            l_pack_ptr=[p["pack_l"] for p in per],
            u_pack_ptr=[p["pack_u"] for p in per],
        )

    def apply(self, r, mesh, axis="rows", plain: bool = False) -> list:
        """z = blockdiag(L_d L_d^T)^-1 r, with no communication: r as D
        shards of rows_per_shard rows (A coords); z returned the same
        way. Each shard's two solves run on its stream (this process's
        shards only)."""
        from tpu_spmv_torch.dist.sharding import _forked, _on
        from tpu_spmv_torch.kernels.sts import (
            lower_solve_blocks, lower_solve_blocks_reference,
        )

        self._check(mesh, axis)
        solve = lower_solve_blocks_reference if plain else lower_solve_blocks
        zs = [None] * self.n_devices
        with _forked(mesh, mesh.streams):
            for d in mesh.local:
                loc = self.local[d]
                with _on(mesh.streams[d]):
                    zero1 = r[d].new_zeros(1)
                    r_ext = torch.cat([r[d], zero1])
                    b_l = (r_ext.index_select(0, loc["g_l"])
                           * loc["inv_l"]).view(self.nc_l + 1, LANES)
                    x_l = torch.cat([solve(loc["slabs_l"], b_l,
                                           loc["steps_l"]).view(-1), zero1])
                    b_u = (x_l.index_select(0, loc["g_u"])
                           * loc["inv_u"]).view(self.nc_u + 1, LANES)
                    x_u = torch.cat([solve(loc["slabs_u"], b_u,
                                           loc["steps_u"]).view(-1), zero1])
                    zs[d] = x_u.index_select(0, loc["g_z"])
        return zs


def from_reference(precond):
    """The port's ShardedIC0Preconditioner or BlockJacobiIC0Preconditioner
    for the JAX package's (its arrays read through NumPy), on the host;
    device_put places it. The plain versions step chunk by chunk."""
    from tpu_spmv_torch.dist.sts import from_reference as solve_from_reference
    from tpu_spmv_torch.formats.sell import to_tensor

    kind = type(precond).__name__
    cls = {"ShardedIC0Preconditioner": ShardedIC0Preconditioner,
           "BlockJacobiIC0Preconditioner": BlockJacobiIC0Preconditioner}[kind]
    fields = {}
    for f in dataclasses.fields(cls):
        if not hasattr(precond, f.name):
            continue
        v = getattr(precond, f.name)
        if f.name in ("lay_l", "lay_u"):
            v = solve_from_reference(v)
        elif f.name.endswith(("gather", "scatter")):
            v = torch.from_numpy(np.asarray(v, np.int64))
        elif not isinstance(v, int):
            v = to_tensor(v)
        fields[f.name] = v
    return cls(**fields)


def pcg_ic0_sharded_init(b, precond, mesh, axis="rows", plain: bool = False):
    """Sharded PCG state (x, r, p, rz) before the first iteration."""
    from tpu_spmv_torch.dist.sharding import each
    from tpu_spmv_torch.dist.solvers import _dot

    z = precond.apply(b, mesh, axis, plain)
    return (each(torch.zeros_like, b), each(torch.clone, b), z,
            _dot(b, z, mesh))


def pcg_ic0_sharded_step(layout, precond, mesh, state, axis="rows",
                         plain: bool = False):
    """One distributed PCG iteration: one sharded SpMV and one
    application of precond (two chains, or two solves a shard), with
    dist/solvers' dots and updates."""
    from tpu_spmv_torch.dist.sharding import spmv_sharded
    from tpu_spmv_torch.dist.solvers import _axpy, _dot

    x, r, p, rz = state
    Ap = spmv_sharded(layout, p, mesh, axis, plain=plain)
    alpha = rz / torch.clamp_min(_dot(p, Ap, mesh), 1e-30)
    x = _axpy(x, alpha, p)
    r = _axpy(r, alpha, Ap, -1.0)
    z = precond.apply(r, mesh, axis, plain)
    rz_new = _dot(r, z, mesh)
    beta = rz_new / torch.clamp_min(rz, 1e-30)
    p = _axpy(z, beta, p)
    return (x, r, p, rz_new)


def capture_pcg_sharded_step(layout, precond, mesh, state, axis="rows"):
    """A CUDA graph of one distributed PCG iteration that advances `state`
    (from pcg_ic0_sharded_init, this process's shards on one card) in
    place at each replay (dist/solvers.capture)."""
    from tpu_spmv_torch.dist.solvers import capture

    return capture(lambda st: pcg_ic0_sharded_step(layout, precond, mesh,
                                                   st, axis), mesh, state)


def pcg_ic0_sharded(layout, b, precond, mesh, axis="rows", iters: int = 50,
                    plain: bool = False, graph: bool | None = None):
    """Distributed PCG with ShardedIC0Preconditioner (exact) or
    BlockJacobiIC0Preconditioner. layout: ShardedRanked or ShardedSell
    placed on mesh; b: the sharded right-hand side. Returns (x sharded,
    final r.z). graph: replay a captured iteration (default: when plain
    is False and dist/solvers.graph_default holds)."""
    from tpu_spmv_torch.dist.solvers import graph_default

    state = pcg_ic0_sharded_init(b, precond, mesh, axis, plain)
    if graph is None:
        graph = not plain and graph_default(mesh)
    if graph and iters > 0:
        g = capture_pcg_sharded_step(layout, precond, mesh, state, axis)
        for _ in range(iters):
            g.replay()
    else:
        for _ in range(iters):
            state = pcg_ic0_sharded_step(layout, precond, mesh, state, axis,
                                         plain)
    return state[0], state[3]


__all__ = [
    "BlockJacobiIC0Preconditioner", "IC0Preconditioner",
    "ShardedIC0Preconditioner", "capture_pcg_sharded_step",
    "capture_pcg_step", "from_reference", "ic0_factor", "pcg_ic0_init",
    "pcg_ic0_sharded", "pcg_ic0_sharded_init", "pcg_ic0_sharded_step",
    "pcg_ic0_solve", "pcg_ic0_step",
]
