"""The plain reference: products and solves in plain PyTorch, on the
benchmark's own copy of the matrix (spmv_bench.matrices), in float64
for the answers and in bfloat16 for the controls. It imports nothing of
the program and takes nothing the program made."""

from __future__ import annotations

import warnings

import torch


def sparse(crow, col, values, size) -> torch.Tensor:
    """torch.sparse_csr_tensor, without its beta-state warning."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow, col, values, size=size,
                                       check_invariants=False)


def operator(csr, dtype=torch.float64, device="cpu") -> torch.Tensor:
    """The matrix as a torch sparse CSR tensor of `dtype` on `device`."""
    return sparse(torch.from_numpy(csr.indptr).to(device),
                  torch.from_numpy(csr.indices.astype("int64")).to(device),
                  torch.from_numpy(csr.data).to(device=device, dtype=dtype),
                  (csr.n, csr.n))


def bf16_operator(csr, device) -> torch.Tensor:
    """The matrix with its values rounded to bfloat16, held in float32."""
    a = operator(csr, torch.float32, device)
    return sparse(a.crow_indices(), a.col_indices(), to_bf16(a.values()),
                  a.shape)


def rel_l2(x: torch.Tensor, ref: torch.Tensor) -> float:
    """||x - ref|| / ||ref||, in float64."""
    ref = ref.to(torch.float64)
    diff = x.to(device=ref.device, dtype=torch.float64) - ref
    return float(torch.linalg.vector_norm(diff)
                 / torch.linalg.vector_norm(ref))


def to_bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bfloat16 and held in float32 (bf16 storage, float32
    accumulation: how a bfloat16 kernel on the card computes)."""
    return t.to(torch.bfloat16).to(torch.float32)
