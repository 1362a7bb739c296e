"""The yardstick's counts and the published peaks.

The counts are what the work needs whatever stores it: float32 values
and no index bytes (a DIA layout needs none), each vector the plain
algorithm reads counted once and each one it writes counted once, and
2 operations a nonzero for a product with A or a triangular solve. So a
layout that pads or indexes more gets no looser bound. The least time
of some work is the larger of its bytes over the HBM rate and its
operations over the float32 rate (NVIDIA's H100 SXM data sheet, at its
700 W limit; the card's own limit is reported beside every run)."""

from __future__ import annotations

import dataclasses

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
L2_BYTES = 50 * 2**20
F32 = 4


@dataclasses.dataclass(frozen=True)
class Work:
    flops: float
    nbytes: float

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.nbytes + other.nbytes)

    def __mul__(self, k: float) -> "Work":
        return Work(self.flops * k, self.nbytes * k)

    @property
    def least_s(self) -> float:
        return max(self.nbytes / HBM_BYTES_PER_S,
                   self.flops / F32_FLOPS_PER_S)


def spmv(n: int, nnz: int) -> Work:
    """y = A x, A n x n: A's values, x read once, y written once."""
    return Work(2.0 * nnz, F32 * (nnz + 2 * n))


def cg_iteration(n: int, nnz: int) -> Work:
    """One CG iteration (Ap = A p; x += a p; r -= a Ap; p = r + b p; two
    dots): A's values once, and p, Ap, x, r each read once and written
    once."""
    return Work(2.0 * nnz, F32 * (nnz + 8 * n))


def cg_start(n: int) -> Work:
    """A CG solve's start from x = 0: b read; x, r, p written."""
    return Work(2.0 * n, F32 * 4 * n)


def pcg_ic0_iteration(n: int, nnz: int, nnz_l: int) -> Work:
    """One IC(0)-PCG iteration: the CG iteration's product and vectors,
    and z = L^-T (L^-1 r): L's values once for each of the two solves,
    and z and the forward solve's y each read once and written once."""
    return Work(2.0 * nnz + 4.0 * nnz_l,
                F32 * (nnz + 2 * nnz_l + 12 * n))


def pcg_ic0_start(n: int, nnz_l: int) -> Work:
    """A PCG solve's start from x = 0: z0 = M^-1 b (L's values twice; b
    and y read; y, z written), x and r written."""
    return Work(4.0 * nnz_l + 2.0 * n, F32 * (2 * nnz_l + 6 * n))
