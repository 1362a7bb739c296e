"""Dense matrix-vector baseline: a library call, not a kernel.

Counterpart of `tpu_spmv/kernels/dense.py`: y = A @ x over the densified
operator, the "what if A were dense" datum beside segsum and bcoo. Its
bytes scale with m * n, not nnz, so it says at which density the sparse
layouts stop paying. PyTorch's `torch.mv` runs it (cuBLAS on a CUDA
card). Materializing A caps it at `max_elems` (64M elements, 256 MB):
`DenseLayout.from_csr` refuses a larger matrix with the reference's
message. A holds the sum of duplicate entries, where the reference's
holds one of them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_spmv_torch import hw
from tpu_spmv_torch.formats.csr import CSRMatrix
from tpu_spmv_torch.formats.sell import TensorLayout

DENSE_MAX_ELEMS = 64 * 2**20


@dataclasses.dataclass
class DenseLayout(TensorLayout):
    """The densified operator, (m, n) float32."""

    a: torch.Tensor
    m: int
    n: int
    nnz: int

    @property
    def hbm_bytes(self) -> int:
        return self.a.numel() * self.a.element_size() + 4 * (self.n + self.m)

    @classmethod
    def from_csr(cls, mat: CSRMatrix, max_elems: int = DENSE_MAX_ELEMS,
                 device=None) -> "DenseLayout":
        """A on `device` (hw.target_device: the card when None), filled
        there from the CSR arrays. Raises ValueError past max_elems."""
        if mat.m * mat.n > max_elems:
            raise ValueError(
                f"dense baseline capped at {max_elems} elements "
                f"({mat.m}x{mat.n} requested); use the sparse kernels"
            )
        device = hw.target_device(device)
        rows = np.repeat(np.arange(mat.m, dtype=np.int64), mat.row_lengths)
        a = torch.zeros((mat.m, mat.n), dtype=torch.float32, device=device)
        # Duplicate (row, column) entries add up, as in every other
        # product here and the oracle; the reference's assignment keeps
        # one of them.
        a.index_put_(
            (torch.from_numpy(rows).to(device),
             torch.from_numpy(mat.indices.astype(np.int64)).to(device)),
            torch.from_numpy(mat.data).to(device), accumulate=True)
        return cls(a, mat.m, mat.n, mat.nnz)


def spmv_dense(layout: DenseLayout, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x on the densified operator."""
    return torch.mv(layout.a, x.float())
