"""Gather + segment-sum SpMV baseline: a library call, not a kernel.

Counterpart of `tpu_spmv/kernels/segsum.py`, the format-agnostic datum
that plays the vendor baselines' role (the reference's MKL/cuSPARSE
runs). There XLA lowers a gather and a sorted segment-sum; here the same
arrays go through PyTorch's gather and `index_add_`, which on CUDA adds
with atomics, so its bits may differ from call to call. The reference
has no Pallas kernel here, and the port has no CUDA kernel: nothing in
this module is a kernel port.

The layout pads nnz to a multiple of `pad_to` with inert entries (row m,
column 0, value 0); row m is one past y and is dropped.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_spmv_torch import hw, obs
from tpu_spmv_torch.formats.csr import CSRMatrix
from tpu_spmv_torch.formats.sell import TensorLayout


@dataclasses.dataclass
class SegsumLayout(TensorLayout):
    """The segment-sum baseline's arrays, equal to the reference's."""

    rows: torch.Tensor  # (nnz_pad,) int32 row of each nonzero (m: padding)
    cols: torch.Tensor  # (nnz_pad,) int32 column (0: padding)
    vals: torch.Tensor  # (nnz_pad,) float32 (0: padding)
    m: int
    n: int
    nnz: int

    @property
    def hbm_bytes(self) -> int:
        """The reference CLI's 12 bytes a nonzero (value, column, row)."""
        return 12 * self.nnz

    @classmethod
    def from_csr(cls, mat: CSRMatrix, pad_to: int = 1024,
                 device=None) -> "SegsumLayout":
        """The reference's arrays, on `device` (hw.target_device: the
        card when None)."""
        device = hw.target_device(device)
        nnz_pad = max(-(-mat.nnz // pad_to) * pad_to, pad_to)
        rows = np.full(nnz_pad, mat.m, dtype=np.int32)
        cols = np.zeros(nnz_pad, dtype=np.int32)
        vals = np.zeros(nnz_pad, dtype=np.float32)
        rows[: mat.nnz] = np.repeat(
            np.arange(mat.m, dtype=np.int32), mat.row_lengths
        )
        cols[: mat.nnz] = mat.indices
        vals[: mat.nnz] = mat.data
        return cls(
            rows=torch.from_numpy(rows).to(device),
            cols=torch.from_numpy(cols).to(device),
            vals=torch.from_numpy(vals).to(device),
            m=mat.m, n=mat.n, nnz=mat.nnz,
        )


@obs.entry
def spmv_segsum(layout: SegsumLayout, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x: gather x at every column, scale, and add the products
    into their rows with index_add_ (the dropped row m takes the
    padding)."""
    prods = layout.vals * x.index_select(0, layout.cols)
    y = torch.zeros(layout.m + 1, dtype=torch.float32, device=x.device)
    return y.index_add_(0, layout.rows, prods)[: layout.m]
