"""Conjugate gradients in plain PyTorch: the float64 solution that the
program's solves are judged against, and the bfloat16 control, which
runs in the program's place under the cell's own stopping rule."""

from __future__ import annotations

import torch

from spmv_bench.reference import bf16_operator, operator, to_bf16
from spmv_bench.reference.ic0 import IC0


def solve(csr, b: torch.Tensor, rtol: float = 1e-12,
          max_iters: int = 20000) -> torch.Tensor:
    """x with ||b - A x|| <= rtol ||b||, in float64 on b's device (CG
    from x = 0, the residual recomputed every 50 iterations so the
    recursion cannot drift from it)."""
    a = operator(csr, torch.float64, b.device)
    b = b.to(torch.float64)
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rz = torch.dot(r, r)
    stop = (rtol * torch.linalg.vector_norm(b)) ** 2
    for it in range(1, max_iters + 1):
        ap = a @ p
        alpha = rz / torch.dot(p, ap)
        x += alpha * p
        r -= alpha * ap
        if it % 50 == 0:
            r = b - a @ x
        rz_new = torch.dot(r, r)
        if it % 10 == 0 and float(rz_new) <= float(stop):
            return x
        p = r + (rz_new / rz) * p
        rz = rz_new
    raise RuntimeError(f"the float64 reference CG did not reach {rtol} in "
                       f"{max_iters} iterations")


def solve_many(csr, bs: torch.Tensor, rtol: float = 1e-12,
               max_iters: int = 20000) -> torch.Tensor:
    """solve() of each row of bs (k, n) at once, on bs's device: the
    float64 operator is built once and each iteration makes one product
    with all k columns; a column that has converged stops moving.
    Returns (k, n) float64."""
    a = operator(csr, torch.float64, bs.device)
    b = bs.to(torch.float64).T.contiguous()
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rz = (r * r).sum(0)
    stop = (rtol * torch.linalg.vector_norm(b, dim=0)) ** 2
    done = torch.zeros_like(rz, dtype=torch.bool)
    for it in range(1, max_iters + 1):
        ap = a @ p
        alpha = torch.where(done, 0.0, rz / (p * ap).sum(0))
        x += alpha * p
        r -= alpha * ap
        if it % 50 == 0:
            r = b - a @ x
        rz_new = (r * r).sum(0)
        if it % 10 == 0:
            done |= rz_new <= stop
            if bool(done.all()):
                return x.T
        p = r + torch.where(done, 0.0, rz_new / rz) * p
        rz = rz_new
    raise RuntimeError(f"the float64 reference CG did not reach {rtol} in "
                       f"{max_iters} iterations")


class Bf16Solver:
    """The control of a solve cell, run in the program's place: CG, or
    with precond "ic0" IC(0)-PCG on a plain IC(0) factor, every value
    stored in bfloat16 (float32 accumulation). It keeps the program's
    state (x, r, p, rz), rz being r.z (r.r for CG), and advances it in
    place: reset(b) starts a solve from x = 0, step() runs one
    iteration."""

    def __init__(self, csr, precond: str, device):
        self.a = bf16_operator(csr, device)
        self.m = None
        if precond == "ic0":
            self.m = IC0(csr, device, to_bf16)
        elif precond != "none":
            raise SystemExit(f"unknown precond {precond!r}")
        x = torch.zeros(csr.n, device=device)
        self.state = (x, x.clone(), x.clone(),
                      torch.zeros((), device=device))

    def _z(self, r: torch.Tensor) -> torch.Tensor:
        return r if self.m is None else self.m.apply(r)

    def reset(self, b: torch.Tensor) -> None:
        x, r, p, rz = self.state
        x.zero_()
        r.copy_(to_bf16(b))
        z = self._z(r)
        p.copy_(z)
        rz.copy_(torch.dot(r, z))

    def step(self) -> None:
        x, r, p, rz = self.state
        ap = to_bf16(self.a @ p)
        alpha = rz / torch.clamp_min(torch.dot(p, ap), 1e-30)
        x.copy_(to_bf16(x + alpha * p))
        r.copy_(to_bf16(r - alpha * ap))
        z = self._z(r)
        rz_new = torch.dot(r, z)
        p.copy_(to_bf16(z + rz_new / torch.clamp_min(rz, 1e-30) * p))
        rz.copy_(rz_new)
