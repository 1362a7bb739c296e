"""Sparse-tensor SpMV baseline: a library call, not a kernel.

Counterpart of `tpu_spmv/kernels/bcoo.py`, the second vendor-library
datum, where JAX's BCOO matvec lowers to XLA gathers and scatters. The
port holds the matrix as a `torch.sparse_csr_tensor` with int32 indices,
whose matvec PyTorch runs through cuSPARSE on a CUDA card (the role of
the reference suite's cusparse-spmv). chip_smoke.py times this same call
as every kernel's "library" column. Nothing here is a kernel port.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_spmv_torch import hw, obs
from tpu_spmv_torch.formats.csr import CSRMatrix


@dataclasses.dataclass
class BCOOLayout:
    """A CSR tensor of the matrix (int32 crow and column indices)."""

    mat: torch.Tensor  # torch.sparse_csr_tensor, shape (m, n)
    m: int
    n: int
    nnz: int

    @property
    def hbm_bytes(self) -> int:
        """The reference CLI's 12 bytes a nonzero (value, column, row)."""
        return 12 * self.nnz

    @property
    def nbytes(self) -> int:
        """Bytes the CSR tensor's three arrays hold on their device."""
        return sum(t.numel() * t.element_size() for t in (
            self.mat.crow_indices(), self.mat.col_indices(),
            self.mat.values()))

    def to(self, device):
        return dataclasses.replace(self, mat=self.mat.to(device))

    def clone(self):
        """Copy with distinct storage (the cold-regime timing)."""
        return dataclasses.replace(self, mat=self.mat.clone())

    @classmethod
    def from_csr(cls, csr: CSRMatrix, device=None) -> "BCOOLayout":
        """The CSR tensor of `csr` on `device` (hw.target_device: the
        card when None)."""
        mat = torch.sparse_csr_tensor(
            torch.from_numpy(csr.indptr), torch.from_numpy(csr.indices),
            torch.from_numpy(csr.data), size=csr.shape,
            device=hw.target_device(device), check_invariants=False,
        )
        return cls(mat=mat, m=csr.m, n=csr.n, nnz=csr.nnz)


@obs.entry
def spmv_bcoo(layout: BCOOLayout, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x (or Y = A @ X for X of shape (n, B)) by the sparse
    tensor's matmul."""
    return layout.mat @ x
