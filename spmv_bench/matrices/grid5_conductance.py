"""A 2D 5-point grid Laplacian with seeded edge conductances: the
pattern of SuiteSparse's McRae/ecology1 (a 1000 x 1000 grid, 4,996,000
nonzeros), whose values the repository does not hold.

Row (i, j) of an nx x ny grid is i * ny + j. Each grid edge has a
conductance drawn uniformly from [c_min, c_max) by the seed; the
off-diagonal entry is minus the edge's conductance (so the matrix is
symmetric) and the diagonal the sum of a row's conductances plus
`shift`, which makes it symmetric positive definite."""

from __future__ import annotations

import numpy as np

from spmv_bench.matrices import Csr, stencil_csr


def generate(config: dict, seed: int) -> Csr:
    nx, ny = int(config["nx"]), int(config["ny"])
    lo, hi = float(config["c_min"]), float(config["c_max"])
    rng = np.random.default_rng(seed % 2**63)
    horiz = np.zeros((nx, ny + 1), np.float64)  # edge (i, j-1)-(i, j) at j
    vert = np.zeros((nx + 1, ny), np.float64)  # edge (i-1, j)-(i, j) at i
    horiz[:, 1:ny] = rng.uniform(lo, hi, (nx, ny - 1))
    vert[1:nx, :] = rng.uniform(lo, hi, (nx - 1, ny))
    up, down = vert[:nx], vert[1:]
    left, right = horiz[:, :ny], horiz[:, 1:]
    diag = up + down + left + right + float(config["shift"])
    values = np.stack([-up, -left, diag, -right, -down]).reshape(5, -1)
    offsets = [(-1, 0), (0, -1), (0, 0), (0, 1), (1, 0)]
    return stencil_csr((nx, ny), offsets, values.astype(np.float32))
