"""The port's baselines (kernels/segsum.py, bcoo.py, dense.py): library
calls in the role of the reference suite's vendor baselines, on the CPU.

Each layout holds the reference's arrays, and each call agrees with the
JAX package's (plain XLA on the CPU: segment-sum, BCOO matvec, dense
matmul) and with the serial oracle on the same matrix and x: RelL2 <=
1e-6 against both, Number Wrong 0 at the magnitude-aware 0.01. The dense
cap refuses with the reference's message.

The rectangular matrix is tests/test_striped.py's generator, which keeps
duplicate entries in a row. The reference's dense layout assigns them,
keeping one; the port's adds them, as the oracle does. Its dense
arrays and product are held to the reference's on the same operator with
the duplicates summed (CSRMatrix.from_coo), and to the oracle on the
matrix as it is.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_spmv.bench.matrices import make as jax_make
from tpu_spmv.formats.csr import CSRMatrix as JaxCSR
from tpu_spmv.kernels.bcoo import BCOOLayout as JaxBCOO
from tpu_spmv.kernels.bcoo import spmv_bcoo as jax_spmv_bcoo
from tpu_spmv.kernels.dense import DenseLayout as JaxDense
from tpu_spmv.kernels.dense import spmv_dense as jax_spmv_dense
from tpu_spmv.kernels.segsum import SegsumLayout as JaxSegsum
from tpu_spmv.kernels.segsum import spmv_segsum as jax_spmv_segsum

from tpu_spmv_torch.bench.harness import validate
from tpu_spmv_torch.formats.csr import CSRMatrix
from tpu_spmv_torch.kernels.bcoo import BCOOLayout, spmv_bcoo
from tpu_spmv_torch.kernels.dense import DENSE_MAX_ELEMS, DenseLayout, spmv_dense
from tpu_spmv_torch.kernels.segsum import SegsumLayout, spmv_segsum

from test_striped import _wide_scattered

MATRICES = {
    "lap2d_32": lambda: jax_make("lap2d_32"),
    "banded_1k": lambda: jax_make("banded_1k"),
    "general_1k": lambda: jax_make("general_1k"),
    "rect_300x2000": lambda: _wide_scattered(300, 2000, 7, seed=4),
}

CALLS = {
    "segsum": (SegsumLayout, spmv_segsum, JaxSegsum, jax_spmv_segsum),
    "bcoo": (BCOOLayout, spmv_bcoo, JaxBCOO, jax_spmv_bcoo),
    "dense": (DenseLayout, spmv_dense, JaxDense, jax_spmv_dense),
}


def _port(jm) -> CSRMatrix:
    return CSRMatrix(jm.indptr, jm.indices, jm.data, jm.shape)


def _summed(jm):
    """The same operator with duplicate entries summed."""
    rows = np.repeat(np.arange(jm.m), np.diff(jm.indptr))
    return JaxCSR.from_coo(rows, jm.indices, jm.data, jm.shape)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("call", sorted(CALLS))
def test_baseline_matches_jax_and_the_oracle(call, name):
    port_cls, port_fn, jax_cls, jax_fn = CALLS[call]
    jm = MATRICES[name]()
    mat = _port(jm)
    x = np.random.default_rng(5).standard_normal(mat.n).astype(np.float32)
    jref = _summed(jm) if call == "dense" else jm
    y_jax = np.asarray(jax_fn(jax_cls.from_csr(jref), jnp.asarray(x)))
    lay = port_cls.from_csr(mat, device="cpu")
    y = port_fn(lay, torch.from_numpy(x)).numpy()
    assert y.shape == (mat.m,) and y.dtype == np.float32
    assert _rel(y, y_jax) <= 1e-6
    wrong, rel = validate(y, mat.matvec(x))
    assert wrong == 0 and rel <= 1e-6, (wrong, rel)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_layouts_hold_the_reference_arrays(name):
    jm = MATRICES[name]()
    mat = _port(jm)
    seg, jseg = SegsumLayout.from_csr(mat, device="cpu"), JaxSegsum.from_csr(jm)
    for f in ("rows", "cols", "vals"):
        assert np.array_equal(getattr(seg, f).numpy(),
                              np.asarray(getattr(jseg, f))), f
    assert (seg.m, seg.n, seg.nnz) == (jseg.m, jseg.n, jseg.nnz)
    assert seg.rows.numel() % 1024 == 0
    dense = DenseLayout.from_csr(mat, device="cpu")
    jdense = JaxDense.from_csr(_summed(jm))
    assert np.array_equal(dense.a.numpy(), np.asarray(jdense.a))
    assert dense.hbm_bytes == jdense.hbm_bytes
    # The CSR tensor's entries are the reference BCOO's (row, column)
    # pairs and values, in the same order.
    bcoo, jbcoo = BCOOLayout.from_csr(mat, device="cpu"), JaxBCOO.from_csr(jm)
    coo = bcoo.mat.to_sparse_coo()
    assert np.array_equal(coo.indices().numpy().T,
                          np.asarray(jbcoo.mat.indices))
    assert np.array_equal(coo.values().numpy(), np.asarray(jbcoo.mat.data))
    assert bcoo.mat.crow_indices().dtype == torch.int32
    assert bcoo.nbytes == 4 * (mat.m + 1 + 2 * mat.nnz)


def test_dense_sums_duplicate_entries():
    """The rectangular matrix has duplicate entries: the reference's
    dense product misses the oracle there, the port's does not."""
    jm = MATRICES["rect_300x2000"]()
    assert _summed(jm).nnz < jm.nnz
    x = np.random.default_rng(5).standard_normal(jm.n).astype(np.float32)
    y_ref = np.asarray(jax_spmv_dense(JaxDense.from_csr(jm), jnp.asarray(x)))
    assert validate(y_ref, jm.matvec(x))[0] > 0
    y = spmv_dense(DenseLayout.from_csr(_port(jm), device="cpu"),
                   torch.from_numpy(x)).numpy()
    assert validate(y, jm.matvec(x))[0] == 0


def test_dense_cap_refuses_with_the_reference_message():
    jm = jax_make("lap2d_32")
    with pytest.raises(ValueError, match="dense baseline capped") as port:
        DenseLayout.from_csr(_port(jm), max_elems=1000, device="cpu")
    with pytest.raises(ValueError) as ref:
        JaxDense.from_csr(jm, max_elems=1000)
    assert str(port.value) == str(ref.value)
    assert DENSE_MAX_ELEMS == 64 * 2**20 == 8192 * 8192


def test_baselines_build_for_the_card_by_default(monkeypatch):
    """Like every builder of the port: no card, no layout, unless the
    caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mat = _port(jax_make("lap2d_32"))
    for cls in (SegsumLayout, BCOOLayout, DenseLayout):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls.from_csr(mat)


@pytest.mark.parametrize("call", sorted(CALLS))
def test_baseline_layouts_clone_for_the_cold_regime(call):
    port_cls, port_fn, _, _ = CALLS[call]
    mat = _port(jax_make("banded_1k"))
    lay = port_cls.from_csr(mat, device="cpu")
    twin = lay.clone()
    assert twin.nbytes == lay.nbytes > 0
    x = torch.ones(mat.n)
    assert torch.equal(port_fn(twin, x), port_fn(lay, x))
