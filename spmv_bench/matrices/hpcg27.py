"""HPCG's operator (GenerateProblem_ref.cpp): the 27-point stencil on an
nx x ny x nz grid, 26 on the diagonal and -1 for each neighbour inside
the grid, rows in HPCG's order (row = iz * nx * ny + iy * nx + ix) and
each row's columns ascending (HPCG's loops over sz, sy, sx). n =
nx * ny * nz; nnz = (3nx - 2)(3ny - 2)(3nz - 2). The seed does not
enter: HPCG's matrix is fixed."""

from __future__ import annotations

import itertools

import numpy as np

from spmv_bench.matrices import Csr, stencil_csr


def generate(config: dict, seed: int) -> Csr:
    dims = (int(config["nz"]), int(config["ny"]), int(config["nx"]))
    offsets = list(itertools.product((-1, 0, 1), repeat=3))
    n = int(np.prod(dims))
    values = np.full((27, n), -1.0, np.float32)
    values[offsets.index((0, 0, 0))] = float(config["diagonal"])
    return stencil_csr(dims, offsets, values)
