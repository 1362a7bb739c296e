"""DIA (diagonal-offset) layout as a torch container: the host builder
of `tpu_spmv.formats.dia`, ported to NumPy plus tensors.

vals is tile-major, (T, D, rb, 128): vals[t, k, r, l] = A[row, row +
off_k] for row = (t*rb + r)*128 + l, zero where the diagonal leaves the
matrix or row >= m. The array equals the JAX package's on the same
matrix. The port adds `offs`, the D offsets as an int32 tensor, so a
kernel reads them from device memory instead of being specialised on
them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_spmv_torch.formats.csr import CSRMatrix
from tpu_spmv_torch.formats.sell import LANES, SUBLANES, TensorLayout

# Admission gates: past this many distinct diagonals, or this much fill,
# the slab formats move fewer bytes (their traffic is O(nnz), DIA's
# O(D * m)).
DIA_MAX_DIAGS = 40
DIA_MAX_FILL = 1.6


def diagonal_profile(mat: CSRMatrix, sample_rows: int = 0):
    """(num_diagonals, fill) of the matrix's diagonal structure.

    fill = D * m / nnz. sample_rows > 0 estimates D from that many evenly
    spaced rows; 0 scans every nonzero.
    """
    if mat.nnz == 0 or mat.m != mat.n:
        return np.iinfo(np.int32).max, float("inf")
    if sample_rows and mat.m > sample_rows:
        step = mat.m // sample_rows
        rows = np.arange(0, mat.m, step, dtype=np.int64)
        parts = []
        for r in rows:
            lo, hi = int(mat.indptr[r]), int(mat.indptr[r + 1])
            parts.append(mat.indices[lo:hi].astype(np.int64) - r)
        offs = np.unique(np.concatenate(parts)) if parts else np.zeros(0)
    else:
        # The distinct offsets col - row, counted on a bitmap of the
        # 2m - 1 possible ones (no sort of the nnz offsets).
        rows = np.repeat(np.arange(mat.m, dtype=np.int64), mat.row_lengths)
        seen = np.zeros(2 * mat.m - 1, dtype=bool)
        seen[mat.indices.astype(np.int64) - rows + (mat.m - 1)] = True
        offs = np.flatnonzero(seen)
    d = int(offs.size)
    return d, d * mat.m / max(mat.nnz, 1)


@dataclasses.dataclass
class DiaSlabs(TensorLayout):
    """D dense diagonals over 128-lane row blocks (see module doc)."""

    vals: torch.Tensor  # (T, D, rb, 128) float32 or bfloat16
    offs: torch.Tensor  # (D,) int32, the offsets below as a tensor
    offsets: tuple  # D diagonal offsets (col - row), ascending
    m: int
    n: int
    nnz: int
    rows_per_tile: int

    @property
    def num_diagonals(self) -> int:
        return len(self.offsets)

    @property
    def num_blocks(self) -> int:
        return int(self.vals.shape[0] * self.vals.shape[2])

    @property
    def padding_ratio(self) -> float:
        return self.vals.numel() / max(self.nnz, 1)

    @property
    def hbm_bytes(self) -> int:
        """Diagonal values + x read once + y written once."""
        return self.vals.numel() * self.vals.element_size() + 4 * (
            self.n + self.m
        )

    @classmethod
    def from_csr(
        cls,
        mat: CSRMatrix,
        max_diags: int = DIA_MAX_DIAGS,
        max_fill: float = DIA_MAX_FILL,
        rows_per_tile: int | None = None,
        val_dtype=None,
    ) -> "DiaSlabs":
        """Build the layout; raises ValueError when the matrix is not
        square, is empty, or fails either admission gate. val_dtype:
        torch.float32 (default) or torch.bfloat16 storage."""
        if mat.m != mat.n:
            raise ValueError("DIA layout requires a square matrix")
        if mat.nnz == 0:
            raise ValueError("DIA layout requires a non-empty matrix")
        m = mat.m
        rows = np.repeat(np.arange(m, dtype=np.int64), mat.row_lengths)
        offs_all = mat.indices.astype(np.int64) - rows
        offsets, inverse = np.unique(offs_all, return_inverse=True)
        d = int(offsets.size)
        if d > max_diags:
            raise ValueError(
                f"{d} distinct diagonals exceeds max_diags={max_diags}"
            )
        fill = d * m / max(mat.nnz, 1)
        if fill > max_fill:
            raise ValueError(
                f"DIA fill {fill:.2f}x exceeds max_fill={max_fill}"
            )
        if rows_per_tile is None:
            # The reference's tile heights, kept so the arrays match.
            rows_per_tile = 65536 if val_dtype == torch.bfloat16 else 32768
        rpt = min(rows_per_tile, -(-m // 1024) * 1024)
        rpt = max(rpt - rpt % (SUBLANES * LANES), 1024)
        rb = rpt // LANES
        nb = max(-(-m // LANES), 1)
        nb_pad = -(-nb // rb) * rb
        vals = np.zeros((d, nb_pad * LANES), np.float32)
        vals[inverse, rows] = mat.data
        vals_tm = np.ascontiguousarray(
            vals.reshape(d, nb_pad // rb, rb, LANES).transpose(1, 0, 2, 3)
        )
        return cls(
            vals=torch.from_numpy(vals_tm).to(val_dtype or torch.float32),
            offs=torch.from_numpy(offsets.astype(np.int32)),
            offsets=tuple(int(o) for o in offsets),
            m=m,
            n=mat.n,
            nnz=mat.nnz,
            rows_per_tile=rpt,
        )
