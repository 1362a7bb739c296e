"""Frozen matrix generators, one module a generator, found by the
`generator` key of a configuration file. Each module has
`generate(config, seed) -> Csr`. They import nothing of the program."""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np


@dataclasses.dataclass
class Csr:
    """A square CSR matrix: int64 row pointers, int32 columns ascending
    within each row, float32 values."""

    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    n: int

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def lower_nnz(self) -> int:
        """Entries on or below the diagonal: the nonzeros of an IC(0)
        factor on this pattern."""
        rows = np.repeat(np.arange(self.n, dtype=np.int64),
                         np.diff(self.indptr))
        return int(np.count_nonzero(self.indices <= rows))


def stencil_csr(dims: tuple, offsets: list, values: np.ndarray) -> Csr:
    """The CSR matrix of a stencil on a grid of `dims` (slowest axis
    first, rows in lexicographic order). offsets: one tuple of per-axis
    steps an entry, in ascending order of column; values: (len(offsets),
    n) float32, the value of each entry at each row (read only where the
    neighbour lies inside the grid)."""
    n = int(np.prod(dims))
    coords = np.indices(dims, dtype=np.int64).reshape(len(dims), n)
    strides = [int(np.prod(dims[a + 1:])) for a in range(len(dims))]
    rows = np.arange(n, dtype=np.int64)
    inside = np.empty((n, len(offsets)), dtype=bool)
    cols = np.empty((n, len(offsets)), dtype=np.int32)
    for o, step in enumerate(offsets):
        ok = np.ones(n, dtype=bool)
        shift = 0
        for a, s in enumerate(step):
            c = coords[a] + s
            ok &= (c >= 0) & (c < dims[a])
            shift += s * strides[a]
        inside[:, o] = ok
        cols[:, o] = rows + shift
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(inside.sum(axis=1), out=indptr[1:])
    return Csr(indptr, cols[inside], np.ascontiguousarray(values.T)[inside],
               n)


def generate(config: dict, seed: int) -> Csr:
    """The matrix of a configuration, by its `generator` module."""
    mod = importlib.import_module(f"spmv_bench.matrices.{config['generator']}")
    return mod.generate(config, seed)
