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
counterpart of the JAX loop's jit. The sharded and block-Jacobi
preconditioners belong to the distributed layer (ROADMAP item A13).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_spmv_torch.formats.csr import CSRMatrix
from tpu_spmv_torch.formats.sell import TensorLayout
from tpu_spmv_torch.sts.host import build_sts, reversed_for_upper, split_lu
from tpu_spmv_torch.sts.solve import LowerSolveLayout, lower_solve


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
    """Factor and the two solve systems. Returns (L, breakdowns, sys_l,
    inv_l, rev, sys_u, inv_u)."""
    import scipy.sparse as sp

    L, bad = ic0_factor(mat)
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
    return L, bad, sys_l, inv_l, rev, sys_u, inv_u


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
    def build(cls, mat: CSRMatrix) -> "IC0Preconditioner":
        L, bad, sys_l, inv_l, rev, sys_u, inv_u = _build_ic0_systems(mat)
        b_dummy = np.zeros(L.m, np.float32)
        return cls(
            lay_l=LowerSolveLayout.build(sys_l, b_dummy),
            lay_u=LowerSolveLayout.build(sys_u, b_dummy),
            idx0=torch.from_numpy(np.asarray(sys_l.perm, np.int64)),
            idx1=torch.from_numpy(inv_l[rev[sys_u.perm]].astype(np.int64)),
            idx2=torch.from_numpy(inv_u[rev].astype(np.int64)),
            breakdowns=bad,
        )

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
    copies, so state is untouched) to build the kernels and set up
    cuBLAS before capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pcg_ic0_step(layout, precond, tuple(t.clone() for t in state))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        new = pcg_ic0_step(layout, precond, state)
        for old, upd in zip(state, new):
            old.copy_(upd)
    return graph


__all__ = [
    "IC0Preconditioner", "capture_pcg_step", "ic0_factor", "pcg_ic0_init",
    "pcg_ic0_solve", "pcg_ic0_step",
]
