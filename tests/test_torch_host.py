"""The port's own host modules against the JAX package's, array for array.

The port carries copies of tpu_spmv's host side (formats/csr.py and
csrk.py, reorder/ with the C++ core, io/, bench/matrices.py and the CLI
loader), so it imports nothing of tpu_spmv. Each copy must give what
the original gives: the same permutations, hierarchies, matrices and
files.
"""

import pathlib

import numpy as np
import pytest

from tpu_spmv.bench import matrices as jmat
from tpu_spmv.formats.csrk import CSRkMatrix as JCSRk
from tpu_spmv.io import read_csr_text as j_read_csr, read_mtx as j_read_mtx
from tpu_spmv.io import write_csr_text as j_write_csr
from tpu_spmv.io import write_mtx as j_write_mtx
from tpu_spmv.reorder import native as jnative
from tpu_spmv.reorder import rcm as j_rcm

from tpu_spmv_torch.bench import matrices as tmat
from tpu_spmv_torch.formats.csr import CSRMatrix
from tpu_spmv_torch.formats.csrk import CSRkMatrix as TCSRk
from tpu_spmv_torch.io import read_csr_text, read_mtx, write_csr_text, write_mtx
from tpu_spmv_torch.reorder import native, rcm
from tpu_spmv_torch.tools.spmv import load_input

REPO = pathlib.Path(__file__).resolve().parent.parent


def _same(a, b):
    assert a.shape == b.shape
    for name in ("indptr", "indices", "data"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name


def test_reorder_core_is_the_reference_source_and_builds():
    ours = REPO / "tpu_spmv_torch" / "reorder" / "csrc" / "reorder.cc"
    assert ours.read_bytes() == (REPO / "tpu_spmv" / "cpp" /
                                 "reorder.cc").read_bytes()
    assert native.available(), native.load_error()
    assert native._LIB_PATH.name == "libtpu_spmv_torch_host.so"
    assert native._LIB_PATH.parent.name == "_build"


@pytest.mark.parametrize("name", ["lap2d_32", "banded_1k", "general_1k"])
@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_rcm_permutation_matches(name, backend):
    mat = tmat.make(name)
    ours = rcm(mat.indptr, mat.indices, backend=backend)
    ref = j_rcm(mat.indptr, mat.indices, backend=backend)
    assert np.array_equal(ours, ref)


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("name", ["lap2d_32", "banded_1k"])
def test_csrk_build_matches(name, k):
    mat = tmat.make(name)
    sizes = (8,) * (k - 1)
    ours = TCSRk.build(mat, k=k, sup_row_sizes=sizes)
    ref = JCSRk.build(jmat.make(name), k=k, sup_row_sizes=sizes)
    assert np.array_equal(ours.perm, ref.perm)
    assert len(ours.maps) == len(ref.maps) == k - 1
    for a, b in zip(ours.maps, ref.maps):
        assert np.array_equal(a, b)
    _same(ours.matrix, ref.matrix)


@pytest.mark.parametrize("name", [
    n for s in ("tiny", "small") for n in jmat.suite_factories(s)
])
def test_suite_matrix_matches(name):
    ours, ref = tmat.make(name), jmat.make(name)
    assert isinstance(ours, CSRMatrix)
    _same(ours, ref)


def test_large_scale_is_searched_last():
    assert tmat.SCALES == ("tiny", "small", "bench", "large")
    assert list(tmat.suite_factories("large")) == ["lap2d_4096",
                                                   "scattered_16m"]
    for s in ("tiny", "small", "bench"):
        assert list(tmat.suite_factories(s)) == list(jmat.suite_factories(s))
    with pytest.raises(KeyError, match="lap2d_4096"):
        tmat.make("no_such_matrix")


def test_scattered_generator_is_the_reference_scripts():
    """scattered_wide draws what results/scattered_16m_r3.py:41-59 draws
    (its rng, then its sort and values), here at 64 x 5000, 9 a row."""
    m, n, per_row = 64, 5000, 9
    rng = np.random.default_rng(0)
    indptr = np.arange(0, m * per_row + 1, per_row, dtype=np.int64)
    indices = rng.integers(0, n, size=m * per_row, dtype=np.int64)
    indices = np.sort(indices.reshape(m, per_row), axis=1).reshape(-1)
    data = rng.standard_normal(m * per_row).astype(np.float32)
    ours = tmat.scattered_wide(m, n, per_row)
    assert ours.shape == (m, n)
    assert np.array_equal(ours.indptr, indptr)
    assert np.array_equal(ours.indices, indices)
    assert np.array_equal(ours.data, data)


@pytest.mark.parametrize("fmt", ["mtx", "csr"])
def test_file_round_trip(tmp_path, fmt):
    """Written by one package, read by the other, both ways; the CLI
    loader reads the port's file."""
    mat = tmat.make("banded_1k")
    write = {"mtx": write_mtx, "csr": write_csr_text}[fmt]
    jwrite = {"mtx": j_write_mtx, "csr": j_write_csr}[fmt]
    read = {"mtx": read_mtx, "csr": read_csr_text}[fmt]
    jread = {"mtx": j_read_mtx, "csr": j_read_csr}[fmt]
    ours, theirs = tmp_path / f"ours.{fmt}", tmp_path / f"ref.{fmt}"
    write(str(ours), mat)
    jwrite(str(theirs), jmat.make("banded_1k"))
    assert ours.read_bytes() == theirs.read_bytes()
    back = read(str(theirs))
    _same(back, jread(str(ours)))
    _same(load_input(str(ours)), back)
    assert np.array_equal(back.indices, mat.indices)
    assert np.allclose(back.data, mat.data, rtol=0, atol=1e-6)
    _same(load_input("synthetic:banded_1k"), mat)


def test_permute_symmetric_matches():
    mat = tmat.make("general_1k")
    perm = np.random.default_rng(3).permutation(mat.m)
    ours = native.permute_symmetric(mat.indptr, mat.indices, mat.data, perm)
    ref = jnative.permute_symmetric(mat.indptr, mat.indices, mat.data, perm)
    for a, b in zip(ours, ref):
        assert np.array_equal(a, b)
    _same(mat.permuted(perm), jmat.make("general_1k").permuted(perm))
