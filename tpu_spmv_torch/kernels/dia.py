"""DIA SpMV: the CUDA kernel csrc/dia.cu and its plain PyTorch version.

`spmv_dia(layout, x)` replaces `tpu_spmv/kernels/dia.py:spmv_dia`. On a
CPU tensor it runs `spmv_dia_reference`; on a CUDA tensor it launches
the kernel or raises. `spmv_dia.launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from tpu_spmv_torch.formats.dia import DiaSlabs
from tpu_spmv_torch.kernels import _build

_VAL_KIND = {torch.float32: 0, torch.bfloat16: 1}


def spmv_dia_reference(layout: DiaSlabs, x: torch.Tensor) -> torch.Tensor:
    """y[row] = sum_k vals[k, row] * x[row + off_k], x zero outside
    [0, n), diagonals added in ascending offset order."""
    m, n = layout.m, layout.n
    d = layout.num_diagonals
    vals = layout.vals.permute(1, 0, 2, 3).reshape(d, -1)[:, :m].float()
    lo = max(0, -min(layout.offsets))
    hi = max(0, max(layout.offsets))
    xp = torch.zeros(lo + max(n, m + hi), dtype=torch.float32, device=x.device)
    xp[lo : lo + n] = x
    y = torch.zeros(m, dtype=torch.float32, device=x.device)
    for k, off in enumerate(layout.offsets):
        y += vals[k] * xp[lo + off : lo + off + m]
    return y


def spmv_dia(layout: DiaSlabs, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with A in DIA layout. x: (n,) float32 -> y: (m,) float32."""
    if x.device.type == "cpu":
        return spmv_dia_reference(layout, x)
    _build.check_operands(layout, x, "spmv_dia")
    if layout.vals.dtype not in _VAL_KIND:
        raise ValueError(f"spmv_dia: unsupported vals dtype {layout.vals.dtype}")
    T, D, rb, lanes = layout.vals.shape
    if layout.offs.dtype != torch.int32 or layout.offs.numel() != D:
        raise ValueError("spmv_dia: offs must be D int32 offsets")
    if T * rb * lanes < layout.m:
        raise ValueError("spmv_dia: vals cover fewer rows than m")
    y = torch.empty(layout.m, dtype=torch.float32, device=x.device)
    if layout.m == 0:
        return y
    rc = _build.library().tsp_spmv_dia(
        _VAL_KIND[layout.vals.dtype], layout.vals.data_ptr(),
        layout.offs.data_ptr(), D, rb, x.data_ptr(), y.data_ptr(),
        layout.m, layout.n, _build.stream_of(x),
    )
    _build.check(rc, "spmv_dia")
    spmv_dia.launches += 1
    return y


spmv_dia.launches = 0
