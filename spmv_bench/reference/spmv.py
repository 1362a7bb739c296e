"""y = A x in float64, and the control: the same product from bfloat16
values and x, rounded to bfloat16."""

from __future__ import annotations

import torch

from spmv_bench.reference import bf16_operator, operator, to_bf16


def products(csr, xs: torch.Tensor) -> torch.Tensor:
    """A @ x for each row x of xs (k, n), in float64, on xs's device."""
    a = operator(csr, torch.float64, xs.device)
    return torch.stack([a @ x.to(torch.float64) for x in xs])


def control(csr, device):
    """The bfloat16 control, to run in the program's place: (a, fn), fn(a,
    x) the product from bfloat16 values and x, rounded to bfloat16."""
    return bf16_operator(csr, device), lambda a, x: to_bf16(a @ to_bf16(x))
