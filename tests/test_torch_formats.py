"""The port's layouts are array-for-array the JAX package's.

Same matrix in, same arrays out: every field of tpu_spmv's DiaSlabs,
SellSlabs and RankedSlabs equals the port's (bf16 compared as its uint16
bits, the packed deltas as the int32 view of their uint32 bits). The
port's one derived field per container, chunk_ptr, is checked against
sub_chunk. formats.convert carries a JAX layout across unchanged.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_spmv.bench.matrices import (
    laplacian_2d, random_banded, random_general, variable_stencil,
)
from tpu_spmv.formats import dia as jdia
from tpu_spmv.formats import sell as jsell
from tpu_spmv.formats.csr import CSRMatrix
from tpu_spmv.reorder.rcm import rcm

from tpu_spmv_torch.formats import dia as tdia
from tpu_spmv_torch.formats import sell as tsell
from tpu_spmv_torch.formats.convert import from_reference, rounded

MATRICES = {
    "lap2d_37": lambda: laplacian_2d(37),
    "banded_1100": lambda: random_banded(1100, 70, 9),
    "banded_640": lambda: random_banded(640, 25, 3),
    "varstencil_31": lambda: variable_stencil(31),
    "general_1000": lambda: random_general(1000, 6),
}
STENCILS = ("lap2d_37", "varstencil_31")


def _rcm(mat):
    return mat.permuted(rcm(mat.indptr, mat.indices))


def to_numpy_bits(t: torch.Tensor) -> np.ndarray:
    """Tensor -> NumPy, bf16 as its uint16 bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def reference_bits(a) -> np.ndarray:
    """A reference array as NumPy, bf16 as its uint16 bits."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def assert_same_layout(ref, port):
    """Every field of the JAX layout equals the port's."""
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(port, f.name)
        if isinstance(b, torch.Tensor):
            an, bn = reference_bits(a), to_numpy_bits(b)
            if an.dtype == np.uint32:
                an = an.view(np.int32)
            assert an.dtype == bn.dtype, (f.name, an.dtype, bn.dtype)
            assert np.array_equal(an, bn), f.name
        else:
            assert a == b, (f.name, a, b)


def assert_chunk_ptr(port):
    counts = np.bincount(
        port.sub_chunk.numpy(), minlength=port.num_chunks + 1
    )[: port.num_chunks]
    ptr = port.chunk_ptr.numpy()
    assert ptr.dtype == np.int32 and ptr.shape == (port.num_chunks + 1,)
    assert ptr[0] == 0 and np.array_equal(np.diff(ptr), counts)


_RANKED_VARIANTS = {
    "f32_grouped": (dict(), dict()),
    "f32_ungrouped": (dict(allow_groups=False), dict(allow_groups=False)),
    "bf16_grouped": (dict(val_dtype=jnp.bfloat16),
                     dict(val_dtype=torch.bfloat16)),
    "bf16_ungrouped": (dict(val_dtype=jnp.bfloat16, allow_groups=False),
                       dict(val_dtype=torch.bfloat16, allow_groups=False)),
    "binned_w4": (dict(bin_blocks=4), dict(bin_blocks=4)),
}


@pytest.mark.parametrize("variant", sorted(_RANKED_VARIANTS))
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_ranked_layout_matches_reference(name, variant):
    mat = _rcm(MATRICES[name]())
    jkw, tkw = _RANKED_VARIANTS[variant]
    ref = jsell.RankedSlabs.from_csr(mat, **jkw)
    port = tsell.RankedSlabs.from_csr(mat, **tkw)
    assert_same_layout(ref, port)
    assert_chunk_ptr(port)
    assert_same_layout(ref, from_reference(ref))


@pytest.mark.parametrize("bins", [0, 4])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_sell_layout_matches_reference(name, bins):
    mat = _rcm(MATRICES[name]())
    ref = jsell.SellSlabs.from_csr(mat, bin_blocks=bins)
    port = tsell.SellSlabs.from_csr(mat, bin_blocks=bins)
    assert_same_layout(ref, port)
    assert_chunk_ptr(port)
    assert_same_layout(ref, from_reference(ref))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", STENCILS)
def test_dia_layout_matches_reference(name, bf16):
    mat = MATRICES[name]()
    ref = jdia.DiaSlabs.from_csr(mat, val_dtype=jnp.bfloat16 if bf16 else None)
    port = tdia.DiaSlabs.from_csr(
        mat, val_dtype=torch.bfloat16 if bf16 else None
    )
    assert_same_layout(ref, port)
    assert port.offs.tolist() == list(port.offsets)
    assert_same_layout(ref, from_reference(ref))
    assert tdia.diagonal_profile(mat) == jdia.diagonal_profile(mat)
    assert tdia.diagonal_profile(mat, 16) == jdia.diagonal_profile(mat, 16)


def test_dia_rejections_match_reference():
    empty = CSRMatrix(np.zeros(5, np.int32), [], [], (4, 4))
    wide = CSRMatrix.from_coo([0, 1], [0, 5], [1.0, 2.0], (2, 6))
    scattered = random_general(600, 8, seed=4)
    for mat in (empty, wide, scattered):
        with pytest.raises(ValueError) as ref:
            jdia.DiaSlabs.from_csr(mat)
        with pytest.raises(ValueError) as port:
            tdia.DiaSlabs.from_csr(mat)
        assert str(port.value) == str(ref.value)


def test_packed_delta_rejection_matches_reference():
    """Two slots of one sub-tile whose window bases lie 312 blocks apart
    exceed the 256-block packed-delta range."""
    rows = np.repeat(np.arange(128), 2)
    cols = np.stack([np.zeros(128, np.int64), 40000 + np.arange(128)], 1)
    mat = CSRMatrix.from_coo(rows, cols.ravel(), np.ones(256), (41000, 41000))
    with pytest.raises(ValueError) as ref:
        jsell.RankedSlabs.from_csr(mat)
    with pytest.raises(ValueError) as port:
        tsell.RankedSlabs.from_csr(mat)
    assert "packed-delta" in str(port.value)
    assert str(port.value) == str(ref.value)


def test_tile_helpers_match_reference():
    for total_k in (8, 512, 1536, 2048, 6144, 9000 * 8, 123456 * 8):
        assert tsell.pick_tile_k(total_k) == jsell.pick_tile_k(total_k)
        for rank_nb, code in (
            (1, 0), (2, 0), (5, 0), (2, (3 << 32) | 0x1), (9, 8 << 32),
        ):
            assert tsell.pad_up_tile(total_k, 8192, rank_nb, code) == (
                jsell.pad_up_tile(total_k, 8192, rank_nb, code)
            )


def test_unroll_budget_matches_reference():
    from tpu_spmv.kernels.pallas_sell import _UNROLL_BUDGET

    assert tsell._UNROLL_BUDGET == _UNROLL_BUDGET


def test_rounded_matches_reference_bits():
    mat = variable_stencil(23)
    rng = np.random.default_rng(5)
    mat = CSRMatrix(mat.indptr, mat.indices,
                    rng.standard_normal(mat.nnz).astype(np.float32) * 1e3,
                    mat.shape)
    ours = rounded(mat).data
    ref = mat.rounded(jnp.bfloat16).data
    assert ours.dtype == ref.dtype == np.float32
    assert np.array_equal(ours.view(np.uint32), ref.view(np.uint32))


def test_layout_container_moves_and_counts():
    mat = _rcm(random_banded(640, 25, 3))
    lay = tsell.RankedSlabs.from_csr(mat, val_dtype=torch.bfloat16)
    assert lay.nbytes == sum(
        t.numel() * t.element_size() for t in lay.tensors().values()
    )
    assert lay.hbm_bytes == (
        lay.vals.numel() * 2 + lay.lcols.numel() * lay.lcols.element_size()
        + 4 * (lay.n + lay.m) + lay.num_subtiles * 128 * 4
    )
    moved, copy = lay.to("cpu"), lay.clone()
    assert moved.vals.device == torch.device("cpu")
    assert copy.vals.data_ptr() != lay.vals.data_ptr()
    assert torch.equal(copy.vals, lay.vals) and copy.m == lay.m
