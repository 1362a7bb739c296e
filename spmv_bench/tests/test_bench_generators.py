"""The frozen generators give the configurations' sizes."""

import itertools
import json

import numpy as np
import pytest
import scipy.sparse as sp

from spmv_bench.matrices import generate
from spmv_bench.run import ROOT, manifest


def _config(name):
    files = {c["name"]: c["file"] for c in manifest()["configs"]}
    with open(ROOT / files[name]) as f:
        return json.load(f)


def _scipy(a):
    return sp.csr_matrix((a.data, a.indices, a.indptr), shape=(a.n, a.n))


def test_configs_state_the_sources_sizes():
    eco, hpcg = _config("ecology1"), _config("hpcg_104")
    assert (eco["n"], eco["nnz"]) == (1_000_000, 4_996_000)
    assert eco["nx"] * eco["ny"] == eco["n"]
    assert 5 * eco["n"] - 2 * eco["nx"] - 2 * eco["ny"] == eco["nnz"]
    assert (hpcg["n"], hpcg["nnz"]) == (1_124_864, 29_791_000)
    assert hpcg["nx"] * hpcg["ny"] * hpcg["nz"] == hpcg["n"]
    assert ((3 * hpcg["nx"] - 2) * (3 * hpcg["ny"] - 2)
            * (3 * hpcg["nz"] - 2)) == hpcg["nnz"]


def test_hpcg_104x4_is_four_ranks_of_hpcg_104():
    one, four = _config("hpcg_104"), _config("hpcg_104x4")
    assert (four["n"], four["nnz"]) == (4_499_456, 119_740_600)
    assert four["nx"] * four["ny"] * four["nz"] == four["n"] == 4 * one["n"]
    assert ((3 * four["nx"] - 2) * (3 * four["ny"] - 2)
            * (3 * four["nz"] - 2)) == four["nnz"]
    assert four["local_grid"] == [one["nx"], one["ny"], one["nz"]]
    assert [four[k] // g for k, g in zip(("nx", "ny", "nz"),
                                         four["process_grid"])] == (
        four["local_grid"])
    assert four["ranks"] == 4 == four["process_grid"][2]
    for key in ("generator", "diagonal", "rcm", "precision", "reduction",
                "check_every", "max_iters", "rhs_seed"):
        assert four[key] == one[key], key


@pytest.mark.parametrize("nx,ny", [(1, 1), (2, 3), (7, 5), (16, 16)])
def test_grid5_size_pattern_and_spd(nx, ny):
    cfg = dict(_config("ecology1"), nx=nx, ny=ny)
    a = generate(cfg, 3)
    assert (a.n, a.nnz) == (nx * ny, 5 * nx * ny - 2 * nx - 2 * ny)
    m = _scipy(a)
    assert abs(m - m.T).max() == 0
    assert np.all(np.diff(a.indptr) >= 1)
    for i in range(a.n):
        assert np.all(np.diff(a.indices[a.indptr[i]:a.indptr[i + 1]]) > 0)
    assert np.linalg.eigvalsh(m.toarray().astype(np.float64)).min() > 0
    assert np.array_equal(generate(cfg, 3).data, a.data)
    assert nx * ny == 1 or not np.array_equal(generate(cfg, 4).data, a.data)


@pytest.mark.parametrize("dims", [(3, 3, 3), (4, 5, 6), (104, 2, 1)])
def test_hpcg27_matches_hpcg_definition(dims):
    nx, ny, nz = dims
    cfg = dict(_config("hpcg_104"), nx=nx, ny=ny, nz=nz)
    a = generate(cfg, 0)
    assert (a.n, a.nnz) == (nx * ny * nz,
                            (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2))
    # GenerateProblem_ref.cpp's loops, entry by entry.
    rows, cols, vals = [], [], []
    for iz, iy, ix in itertools.product(range(nz), range(ny), range(nx)):
        row = iz * nx * ny + iy * nx + ix
        for sz, sy, sx in itertools.product((-1, 0, 1), repeat=3):
            if 0 <= iz + sz < nz and 0 <= iy + sy < ny and 0 <= ix + sx < nx:
                rows.append(row)
                cols.append(row + sz * nx * ny + sy * nx + sx)
                vals.append(26.0 if (sz, sy, sx) == (0, 0, 0) else -1.0)
    ref = sp.csr_matrix((vals, (rows, cols)), shape=(a.n, a.n))
    assert abs(_scipy(a) - ref).max() == 0
    assert np.array_equal(a.indices, ref.indices)
    assert a.lower_nnz() == (a.nnz + a.n) // 2
