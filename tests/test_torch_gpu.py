"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

Marked `gpu`; every test skips inside its fixture when no CUDA card is
present (never at import, so every test worker collects the same tests).
This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerances: kernel and plain version both sum in f32, in different
orders and with or without fused multiply-add, so they agree to
1e-5 * max(1, max |y|), not bit for bit. Against the serial CSR oracle
the bar is the suite's: Number Wrong 0 at the magnitude-aware 0.01 and
RelL2 <= 1e-6 (bf16 layouts against the bf16-rounded operator).
"""

import numpy as np
import pytest
import torch

from tpu_spmv.bench.matrices import (
    laplacian_2d, random_banded, random_general, variable_stencil,
)
from tpu_spmv.reorder.rcm import rcm

from tpu_spmv_torch.bench.harness import bench_spmv, bench_spmv_cold, validate
from tpu_spmv_torch.formats.convert import rounded
from tpu_spmv_torch.formats.dia import DiaSlabs
from tpu_spmv_torch.formats.sell import RankedSlabs, SellSlabs
from tpu_spmv_torch.kernels.dia import spmv_dia, spmv_dia_reference
from tpu_spmv_torch.kernels.sell import (
    spmv_ranked, spmv_ranked_reference, spmv_sell, spmv_sell_reference,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rcm(mat):
    return mat.permuted(rcm(mat.indptr, mat.indices))


def _run(kernel, plain, layout, mat, oracle, dev):
    lay = layout.to(dev)
    x = np.random.default_rng(3).standard_normal(mat.n).astype(np.float32)
    xt = torch.from_numpy(x).to(dev)
    before = kernel.launches
    yk = kernel(lay, xt)
    yp = plain(lay, xt)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    scale = max(1.0, float(yp.abs().max()))
    assert float((yk - yp).abs().max()) <= 1e-5 * scale
    wrong, rel = validate(yk.cpu().numpy(), oracle.matvec(x))
    assert wrong == 0 and rel <= 1e-6, (wrong, rel)


@pytest.mark.parametrize("mat", [laplacian_2d(70), variable_stencil(53)],
                         ids=["lap2d", "varstencil"])
@pytest.mark.parametrize("vdt", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_dia_kernel_matches_plain(cuda, mat, vdt):
    lay = DiaSlabs.from_csr(mat, val_dtype=vdt)
    oracle = rounded(mat) if vdt else mat
    _run(spmv_dia, spmv_dia_reference, lay, mat, oracle, cuda)


_RANKED = {
    "banded_grouped": (lambda: _rcm(random_banded(3000, 90, 11, seed=1)), {}),
    "banded_ungrouped": (lambda: _rcm(random_banded(3000, 90, 11, seed=1)),
                         dict(allow_groups=False)),
    "banded_bf16": (lambda: _rcm(random_banded(3000, 90, 11, seed=1)),
                    dict(val_dtype=torch.bfloat16)),
    "general_binned_w4": (lambda: _rcm(random_general(2500, 6, seed=2)),
                          dict(bin_blocks=4)),
    "lap2d_u8_ungrouped": (lambda: _rcm(laplacian_2d(60)),
                           dict(allow_groups=False)),
    "general_i32_lcols": (lambda: random_general(50000, 6, seed=1),
                          dict(align=False)),
}


@pytest.mark.parametrize("case", sorted(_RANKED))
def test_ranked_kernel_matches_plain(cuda, case):
    make, kw = _RANKED[case]
    mat = make()
    lay = RankedSlabs.from_csr(mat, **kw)
    oracle = rounded(mat) if kw.get("val_dtype") else mat
    _run(spmv_ranked, spmv_ranked_reference, lay, mat, oracle, cuda)


@pytest.mark.parametrize("bins", [0, 4])
def test_sell_kernel_matches_plain(cuda, bins):
    mat = _rcm(random_general(2500, 6, seed=2))
    lay = SellSlabs.from_csr(mat, bin_blocks=bins)
    _run(spmv_sell, spmv_sell_reference, lay, mat, mat, cuda)


def test_wrapper_refuses_bad_operands(cuda):
    mat = laplacian_2d(20)
    lay = DiaSlabs.from_csr(mat).to(cuda)
    with pytest.raises(ValueError):
        spmv_dia(lay, torch.zeros(mat.n, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        spmv_dia(DiaSlabs.from_csr(mat), torch.zeros(mat.n, device=cuda))


def test_timing_on_card(cuda):
    mat = laplacian_2d(64)
    lay = DiaSlabs.from_csr(mat).to(cuda)
    x = torch.ones(mat.n, device=cuda)
    warm = bench_spmv(spmv_dia, lay, x, samples=2)
    # A tiny operator: pretend L2 holds one copy, so K stays small.
    cold = bench_spmv_cold(spmv_dia, lay.clone, x, nnz=mat.nnz,
                           layout_bytes=lay.nbytes, l2_bytes=lay.nbytes,
                           samples=2)
    assert warm.regime == "warm" and cold.regime == "cold"
    assert 0 < warm.time_min <= warm.time_avg <= warm.time_max
    assert cold.iters[2] == 4
