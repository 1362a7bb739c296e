"""Reference-class matrix generators — the SuiteSparse benchmark-set role.

The port's copy of `tpu_spmv.tools.gen` (host code, no device), held
equal to it by tests/test_torch_tools.py.

The reference's benchmark inputs are ~18 SuiteSparse matrices
(helpers/params.txt:1-122: roadNet-TX, delaunay_n20, thermal2,
ecology1, G3_circuit, ...). Without a download, this CLI builds the
same structural CLASSES locally and persists them as
.mtx files for the full file-based pipeline
(convert -> RCM -> plan -> kernel — run_scripts/run_*.py iterate
directories of such files, run_epyc.py:85-100):

  road <n>       road-network class (roadNet-TX): random planar points,
                 k-nearest-neighbor edges, avg degree ~2.5, SPD via
                 Laplacian + unit diagonal
  delaunay <n>   delaunay_nXX class: Delaunay triangulation adjacency
                 (pattern weights) + diagonal
  fem <n>        thermal2/Emilia class: P1 FEM cotangent-stiffness
                 matrix assembled on a Delaunay mesh (SPD, ~7 nnz/row)
  fem3d <g>      3D hexahedral-element class: 27-point stencil on a
                 g^3 grid with per-element random coefficients,
                 diagonally dominant

Usage:
  python -m tpu_spmv_torch.tools.gen road 2000000 --out data/road_2m.mtx
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _spd_from_graph(rows, cols, w, n):
    """Symmetric (rows, cols, w) edge soup -> SPD CSR: L = D - W + I."""
    from tpu_spmv_torch.formats.csr import CSRMatrix

    both_r = np.concatenate([rows, cols])
    both_c = np.concatenate([cols, rows])
    both_w = np.concatenate([w, w])
    # Deduplicate (undirected edges may appear twice in kNN soup).
    key = both_r.astype(np.int64) * n + both_c
    _, first = np.unique(key, return_index=True)
    both_r, both_c, both_w = both_r[first], both_c[first], both_w[first]
    off = both_r != both_c
    both_r, both_c, both_w = both_r[off], both_c[off], both_w[off]
    deg = np.zeros(n, np.float64)
    np.add.at(deg, both_r, both_w)
    all_r = np.concatenate([both_r, np.arange(n)])
    all_c = np.concatenate([both_c, np.arange(n)])
    all_v = np.concatenate([-both_w, deg + 1.0])
    return CSRMatrix.from_coo(all_r, all_c, all_v.astype(np.float32), (n, n))


def gen_road(n: int, seed: int = 0):
    """Random planar kNN graph: roadNet-class degree (~2.5 avg) and
    2D spatial locality (long RCM-reducible bands)."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2))
    tree = cKDTree(pts)
    # k=4 neighbors, then keep each edge with p s.t. avg degree ~2.6
    # (road networks are almost planar chains with sparse junctions).
    _, idx = tree.query(pts, k=4)
    rows = np.repeat(np.arange(n, dtype=np.int64), 3)
    cols = idx[:, 1:].reshape(-1).astype(np.int64)
    keep = rng.random(rows.size) < 0.45
    rows, cols = rows[keep], cols[keep]
    w = np.ones(rows.size)
    return _spd_from_graph(rows, cols, w, n)


def _delaunay_edges(n: int, seed: int):
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2))
    tri = Delaunay(pts)
    s = tri.simplices.astype(np.int64)
    rows = np.concatenate([s[:, 0], s[:, 1], s[:, 2]])
    cols = np.concatenate([s[:, 1], s[:, 2], s[:, 0]])
    return pts, s, rows, cols


def gen_delaunay(n: int, seed: int = 1):
    """Delaunay triangulation adjacency (delaunay_nXX class)."""
    _, _, rows, cols = _delaunay_edges(n, seed)
    return _spd_from_graph(rows, cols, np.ones(rows.size), n)


def gen_fem(n: int, seed: int = 2):
    """P1 FEM stiffness (cotangent weights) on a Delaunay mesh — the
    thermal2/Emilia_923 class: SPD, ~7 nnz/row, mesh-local structure."""
    from tpu_spmv_torch.formats.csr import CSRMatrix

    pts, s, _, _ = _delaunay_edges(n, seed)
    p0, p1, p2 = pts[s[:, 0]], pts[s[:, 1]], pts[s[:, 2]]
    # Cotangent of the angle at vertex k (opposite edge (i, j)).
    def cot(a, b, c):  # angle at a
        u, v = b - a, c - a
        cross = np.abs(u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0])
        return (u * v).sum(1) / np.maximum(cross, 1e-12)

    c0, c1, c2 = cot(p0, p1, p2), cot(p1, p2, p0), cot(p2, p0, p1)
    # Edge (i,j) accumulates cot(angle at the opposite vertex) / 2.
    rows = np.concatenate([s[:, 1], s[:, 2], s[:, 0]]).astype(np.int64)
    cols = np.concatenate([s[:, 2], s[:, 0], s[:, 1]]).astype(np.int64)
    w = 0.5 * np.concatenate([c0, c1, c2])
    w = np.clip(w, 1e-6, None)  # obtuse triangles: keep SPD-ish
    # Accumulate duplicate edges (each interior edge is in 2 triangles).
    key = np.minimum(rows, cols) * n + np.maximum(rows, cols)
    order = np.argsort(key, kind="stable")
    key_s, rows_s, cols_s, w_s = key[order], rows[order], cols[order], w[order]
    starts = np.flatnonzero(
        np.concatenate(([True], key_s[1:] != key_s[:-1]))
    )
    w_acc = np.add.reduceat(w_s, starts)
    rows_u, cols_u = rows_s[starts], cols_s[starts]
    deg = np.zeros(n, np.float64)
    np.add.at(deg, rows_u, w_acc)
    np.add.at(deg, cols_u, w_acc)
    all_r = np.concatenate([rows_u, cols_u, np.arange(n)])
    all_c = np.concatenate([cols_u, rows_u, np.arange(n)])
    all_v = np.concatenate([-w_acc, -w_acc, deg + 1e-3])
    return CSRMatrix.from_coo(
        all_r, all_c, all_v.astype(np.float32), (n, n)
    )


def gen_fem3d(g: int, seed: int = 3):
    """27-point stencil on a g^3 grid with per-node random coefficients
    (trilinear hexahedral elements, lumped): diagonally dominant SPD."""
    from tpu_spmv_torch.formats.csr import CSRMatrix

    rng = np.random.default_rng(seed)
    n = g ** 3
    coeff = rng.uniform(0.5, 2.0, n)
    ids = np.arange(n, dtype=np.int64)
    z, rem = ids // (g * g), ids % (g * g)
    y, x = rem // g, rem % g
    rows_l, cols_l, vals_l = [], [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dz == dy == dx == 0:
                    continue
                ok = (
                    (x + dx >= 0) & (x + dx < g)
                    & (y + dy >= 0) & (y + dy < g)
                    & (z + dz >= 0) & (z + dz < g)
                )
                nbr = ids + dz * g * g + dy * g + dx
                # Weight falls off with taxicab distance (FEM-like).
                wgt = 1.0 / (abs(dx) + abs(dy) + abs(dz))
                rows_l.append(ids[ok])
                cols_l.append(nbr[ok])
                vals_l.append(
                    -wgt * 0.5 * (coeff[ids[ok]] + coeff[nbr[ok]])
                )
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    vals = np.concatenate(vals_l)
    deg = np.zeros(n, np.float64)
    np.add.at(deg, rows, -vals)
    all_r = np.concatenate([rows, ids])
    all_c = np.concatenate([cols, ids])
    all_v = np.concatenate([vals, deg + 1.0])
    return CSRMatrix.from_coo(
        all_r, all_c, all_v.astype(np.float32), (n, n)
    )


GENERATORS = {
    "road": gen_road,
    "delaunay": gen_delaunay,
    "fem": gen_fem,
    "fem3d": gen_fem3d,
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("family", choices=sorted(GENERATORS))
    ap.add_argument("size", type=int,
                    help="rows (road/delaunay/fem) or grid side (fem3d)")
    ap.add_argument("--out", required=True, help=".mtx output path")
    ap.add_argument("--seed", type=int, default=None)
    args = ap.parse_args(argv)

    kw = {} if args.seed is None else {"seed": args.seed}
    mat = GENERATORS[args.family](args.size, **kw)
    from tpu_spmv_torch.io import write_mtx

    write_mtx(
        args.out, mat,
        comment=f" tpu_spmv gen {args.family} {args.size}",
    )
    print(
        f"{args.out}: {mat.m} rows, {mat.nnz} nnz "
        f"({mat.nnz / mat.m:.2f}/row)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
