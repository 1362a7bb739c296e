"""Synthetic benchmark matrices.

The reference benchmarks SuiteSparse matrices staged under ~/matrices
(names recoverable from helpers/params.txt:1-123: thermal2, ecology1,
G3_circuit, bmwcra_1, delaunay_n20, roadNet-TX, ...). Those files are not
redistributable inside this repo, so we generate structurally analogous
families offline:

  * laplacian_2d/3d  — 5/7-point stencils (ecology1, G3_circuit, thermal2
    class): symmetric, ~5-7 nnz/row, banded after RCM.
  * random_banded    — random symmetric matrices with controlled bandwidth
    and nnz/row (FEM-like: bmwcra_1, Emilia_923 class).
  * random_general   — scattered symmetric pattern (delaunay/roadNet class,
    stresses the reorderer).

The port's copy of `tpu_spmv.bench.matrices`, held equal to it by
tests/test_torch_host.py, with one more scale, "large", of matrices
whose x exceeds the H100's 50 MB L2: lap2d_4096, the same Laplacian
family at 16.8M rows (x 67 MB, the windowed kernels' path), and
scattered_16m, the reference's own scattered datapoint
(results/scattered_16m_r3.py: 131,072 rows, 16,777,216 columns, x 64
MB, no band locality; the column-striped path).
"""

from __future__ import annotations

import numpy as np

from tpu_spmv_torch.formats.csr import CSRMatrix


def laplacian_2d(nx: int, ny: int | None = None) -> CSRMatrix:
    """5-point Laplacian on an nx-by-ny grid, natural (row-major) order."""
    ny = ny or nx
    idx = np.arange(nx * ny, dtype=np.int64).reshape(nx, ny)
    rows, cols, vals = [], [], []

    def add(r, c, v):
        rows.append(r.ravel())
        cols.append(c.ravel())
        vals.append(np.full(r.size, v, dtype=np.float32))

    add(idx, idx, 4.0)
    add(idx[1:, :], idx[:-1, :], -1.0)
    add(idx[:-1, :], idx[1:, :], -1.0)
    add(idx[:, 1:], idx[:, :-1], -1.0)
    add(idx[:, :-1], idx[:, 1:], -1.0)
    return CSRMatrix.from_coo(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals),
        (nx * ny, nx * ny),
    )


def laplacian_3d(nx: int, ny: int | None = None, nz: int | None = None) -> CSRMatrix:
    """7-point Laplacian on an nx*ny*nz grid."""
    ny = ny or nx
    nz = nz or nx
    idx = np.arange(nx * ny * nz, dtype=np.int64).reshape(nx, ny, nz)
    rows, cols, vals = [], [], []

    def add(r, c, v):
        rows.append(r.ravel())
        cols.append(c.ravel())
        vals.append(np.full(r.size, v, dtype=np.float32))

    add(idx, idx, 6.0)
    for axis in range(3):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[axis] = slice(1, None)
        hi[axis] = slice(None, -1)
        add(idx[tuple(lo)], idx[tuple(hi)], -1.0)
        add(idx[tuple(hi)], idx[tuple(lo)], -1.0)
    n = nx * ny * nz
    return CSRMatrix.from_coo(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), (n, n)
    )


def variable_stencil(nx: int, ny: int | None = None, seed: int = 0) -> CSRMatrix:
    """5-point grid pattern with VARYING coefficients (thermal2/ecology1
    class: the real SuiteSparse stencils are not constant-valued).
    Symmetric, diagonally dominant (SPD, CG-usable). Distinguishes the
    DIA fast path's constant-friendly cases from the general one — and
    bf16 value storage is no longer exact here (validated against the
    rounded operator instead)."""
    ny = ny or nx
    rng = np.random.default_rng(seed)
    idx = np.arange(nx * ny, dtype=np.int64).reshape(nx, ny)
    rows, cols, vals = [], [], []

    def add_sym(r, c):
        v = (0.5 + rng.random(r.size)).astype(np.float32)  # in [0.5, 1.5)
        rows.append(r.ravel())
        cols.append(c.ravel())
        vals.append(v)
        rows.append(c.ravel())
        cols.append(r.ravel())
        vals.append(v)

    add_sym(idx[1:, :], idx[:-1, :])
    add_sym(idx[:, 1:], idx[:, :-1])
    n = nx * ny
    all_rows = np.concatenate(rows)
    all_cols = np.concatenate(cols)
    all_vals = -np.concatenate(vals)
    diag = np.ones(n, np.float64)
    np.add.at(diag, all_rows, np.abs(all_vals.astype(np.float64)))
    return CSRMatrix.from_coo(
        np.concatenate([all_rows, np.arange(n, dtype=np.int64)]),
        np.concatenate([all_cols, np.arange(n, dtype=np.int64)]),
        np.concatenate([all_vals, diag.astype(np.float32)]),
        (n, n),
    )


def random_banded(
    m: int, band: int, avg_nnz_per_row: float, seed: int = 0,
    diagonally_dominant: bool = True,
) -> CSRMatrix:
    """Random symmetric matrix with |i-j| <= band and ~avg_nnz_per_row."""
    rng = np.random.default_rng(seed)
    per_row = max(int(avg_nnz_per_row) // 2, 1)  # half above, mirrored below
    rows = np.repeat(np.arange(m, dtype=np.int64), per_row)
    offsets = rng.integers(1, band + 1, size=rows.shape[0])
    cols = np.minimum(rows + offsets, m - 1)
    keep = cols != rows  # the diagonal is added separately below
    rows, cols = rows[keep], cols[keep]
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    # Symmetrize.
    all_rows = np.concatenate([rows, cols])
    all_cols = np.concatenate([cols, rows])
    all_vals = np.concatenate([vals, vals])
    if diagonally_dominant:
        # Strict row-wise dominance => symmetric => SPD (needed for CG).
        rowsum = np.zeros(m, dtype=np.float64)
        off = all_rows != all_cols
        np.add.at(rowsum, all_rows[off], np.abs(all_vals[off].astype(np.float64)))
        diag = (rowsum + 1.0).astype(np.float32)
    else:
        diag = rng.standard_normal(m).astype(np.float32)
    all_rows = np.concatenate([all_rows, np.arange(m, dtype=np.int64)])
    all_cols = np.concatenate([all_cols, np.arange(m, dtype=np.int64)])
    all_vals = np.concatenate([all_vals, diag])
    return CSRMatrix.from_coo(all_rows, all_cols, all_vals, (m, m))


def random_general(m: int, avg_nnz_per_row: float, seed: int = 0) -> CSRMatrix:
    """Random symmetric pattern with no band structure (reorderer stress)."""
    rng = np.random.default_rng(seed)
    per_row = max(int(avg_nnz_per_row) // 2, 1)
    rows = np.repeat(np.arange(m, dtype=np.int64), per_row)
    cols = rng.integers(0, m, size=rows.shape[0])
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    all_rows = np.concatenate([rows, cols, np.arange(m, dtype=np.int64)])
    all_cols = np.concatenate([cols, rows, np.arange(m, dtype=np.int64)])
    all_vals = np.concatenate([vals, vals, np.ones(m, dtype=np.float32)])
    return CSRMatrix.from_coo(all_rows, all_cols, all_vals, (m, m))


def power_law(m: int, avg_nnz_per_row: float = 8, alpha: float = 1.3,
              max_len: int = 2048, seed: int = 0) -> CSRMatrix:
    """Power-law degree distribution with mild locality (roadNet/lp1/
    delaunay class): most rows short, a heavy tail of long rows. The
    skewed lengths stress SELL padding (the sigma row sort's target) the
    way short-row SuiteSparse matrices stressed the reference's AVX-512
    lt4/gt4 dispatch (spmv-intrin.c:119-223)."""
    rng = np.random.default_rng(seed)
    lens = np.minimum(
        (rng.pareto(alpha, m) * avg_nnz_per_row * (alpha - 1) / alpha + 1)
        .astype(np.int64),
        max_len,
    )
    rows = np.repeat(np.arange(m, dtype=np.int64), lens)
    # Mild locality: half the entries near the diagonal, half uniform.
    near = rng.integers(-2000, 2001, rows.shape[0])
    far = rng.integers(0, m, rows.shape[0])
    use_near = rng.random(rows.shape[0]) < 0.5
    cols = np.where(use_near, np.clip(rows + near, 0, m - 1), far)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    all_rows = np.concatenate([rows, np.arange(m, dtype=np.int64)])
    all_cols = np.concatenate([cols, np.arange(m, dtype=np.int64)])
    all_vals = np.concatenate([vals, np.ones(m, dtype=np.float32)])
    return CSRMatrix.from_coo(all_rows, all_cols, all_vals, (m, m))


def scattered_wide(m: int, n: int, per_row: int,
                   seed: int = 0) -> CSRMatrix:
    """m rows of per_row uniformly random columns in [0, n) (sorted in
    each row, duplicates kept) with standard-normal values: the generator
    of results/scattered_16m_r3.py:41-59, whose rng goes on to draw x."""
    rng = np.random.default_rng(seed)
    indptr = np.arange(0, m * per_row + 1, per_row, dtype=np.int64)
    indices = rng.integers(0, n, size=m * per_row, dtype=np.int64)
    indices = np.sort(indices.reshape(m, per_row), axis=1).reshape(-1)
    data = rng.standard_normal(m * per_row).astype(np.float32)
    return CSRMatrix(indptr, indices.astype(np.int32), data, (m, n))


def suite_factories(scale: str = "small") -> dict:
    """Name -> zero-arg constructor for the synthetic suite (nothing is
    built until a factory is called — CLI name lookups stay cheap)."""
    if scale == "tiny":
        return {
            "lap2d_32": lambda: laplacian_2d(32),
            "banded_1k": lambda: random_banded(1000, 40, 8, seed=1),
            "general_1k": lambda: random_general(1000, 6, seed=2),
        }
    if scale == "small":
        return {
            "lap2d_256": lambda: laplacian_2d(256),
            "lap3d_32": lambda: laplacian_3d(32),
            "varstencil_128": lambda: variable_stencil(128, seed=4),
            "banded_100k": lambda: random_banded(100_000, 500, 16, seed=1),
            "general_50k": lambda: random_general(50_000, 8, seed=2),
            "powerlaw_100k": lambda: power_law(100_000, 8, seed=3),
        }
    if scale == "bench":
        # Sized like the reference's mid/large SuiteSparse set
        # (thermal2 ~1.2M rows/8.5M nnz, ecology1 1M/5M, G3_circuit 1.5M/7.6M).
        return {
            "lap2d_1024": lambda: laplacian_2d(1024),    # 1.05M rows, 5.2M nnz
            "lap3d_101": lambda: laplacian_3d(101),      # 1.03M rows, 7.2M nnz
            "varstencil_1024": lambda: variable_stencil(1024, seed=4),
            "banded_1m": lambda: random_banded(1_000_000, 1000, 16, seed=1),
            "general_500k": lambda: random_general(500_000, 10, seed=2),
            "powerlaw_1m": lambda: power_law(1_000_000, 8, seed=3),
        }
    if scale == "large":
        return {
            "lap2d_4096": lambda: laplacian_2d(4096),    # 16.8M rows, 83.9M nnz
            # 131,072 rows x 16,777,216 columns, 160 a row: 21.0M nnz
            "scattered_16m": lambda: scattered_wide(131_072, 16_777_216, 160),
        }
    raise ValueError(f"unknown scale {scale!r}")


def suite(scale: str = "small") -> dict:
    """Named matrix families mirroring the reference's benchmark set
    roles (eagerly built; prefer suite_factories for lookups)."""
    return {k: f() for k, f in suite_factories(scale).items()}


# Scales in the order make() searches them.
SCALES = ("tiny", "small", "bench", "large")


def make(name: str):
    """Build one named suite matrix without constructing the others."""
    for scale in SCALES:
        f = suite_factories(scale).get(name)
        if f is not None:
            return f()
    raise KeyError(
        f"unknown synthetic matrix {name!r}; known: "
        + ", ".join(
            n for s in SCALES for n in suite_factories(s)
        )
    )
