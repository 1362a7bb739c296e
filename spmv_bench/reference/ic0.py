"""Incomplete Cholesky with no fill, IC(0), in plain PyTorch: the factor
L (lower, on A's own lower pattern, L L^T = A on that pattern) and the
two triangular solves of M^-1 r = L^-T (L^-1 r), each value rounded as
it is produced by `rnd` (to_bf16 for the bfloat16 control).

Rows are processed by levels of the lower pattern's dependency graph
(a row's level is one more than the highest of the rows it reads), each
level in one vectorized step. A row's strict-lower entries sit in a
padded (n + 1, width) table, columns ascending; the pad column is n,
whose vector slot is kept at 0."""

from __future__ import annotations

import numpy as np
import torch


def _lower_table(csr, device):
    """Strict-lower columns and values of each row, padded: (cols,
    vals, diag), cols (n + 1, w) int64 with n in the pads and in row n,
    vals (n + 1, w) float32 with 0 there, diag (n + 1,) with 1 at n."""
    n = csr.n
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(csr.indptr))
    cols = csr.indices.astype(np.int64)
    strict = cols < rows
    on_diag = cols == rows
    diag = np.ones(n + 1, np.float32)
    diag[rows[on_diag]] = csr.data[on_diag]
    r, c, v = rows[strict], cols[strict], csr.data[strict]
    count = np.bincount(r, minlength=n)
    w = max(int(count.max(initial=0)), 1)
    start = np.zeros(n, np.int64)
    np.cumsum(count[:-1], out=start[1:])
    pos = np.arange(r.size, dtype=np.int64) - start[r]
    tab_c = np.full((n + 1, w), n, np.int64)
    tab_v = np.zeros((n + 1, w), np.float32)
    tab_c[r, pos] = c
    tab_v[r, pos] = v
    return (torch.from_numpy(tab_c).to(device),
            torch.from_numpy(tab_v).to(device),
            torch.from_numpy(diag).to(device))


def _levels(cols: torch.Tensor, n: int) -> list:
    """The rows of each level, in order (a list of int64 tensors), from
    the padded columns of the dependency graph."""
    level = torch.zeros(n + 1, dtype=torch.int64, device=cols.device)
    valid = cols[:n] < n
    while True:
        new = torch.where(valid, level[cols[:n]] + 1, 0).amax(dim=1)
        if torch.equal(new, level[:n]):
            break
        level[:n] = new
    order = torch.argsort(level[:n], stable=True)
    sizes = torch.bincount(level[:n]).tolist()
    return list(torch.split(order, sizes))


def _transpose(cols: torch.Tensor, vals: torch.Tensor, n: int):
    """The padded table of L^T's strict-upper rows: for each i, the rows
    k > i that read column i, and their values."""
    k = torch.arange(n, device=cols.device).repeat_interleave(cols.shape[1])
    c, v = cols[:n].reshape(-1), vals[:n].reshape(-1)
    keep = c < n
    k, c, v = k[keep], c[keep], v[keep]
    order = torch.argsort(c, stable=True)
    k, c, v = k[order], c[order], v[order]
    count = torch.bincount(c, minlength=n)
    start = torch.cumsum(count, 0) - count
    pos = torch.arange(c.numel(), device=c.device) - start[c]
    w = max(int(count.max()) if n else 0, 1)
    tab_c = torch.full((n + 1, w), n, dtype=torch.int64, device=cols.device)
    tab_v = torch.zeros((n + 1, w), dtype=vals.dtype, device=cols.device)
    tab_c[c, pos] = k
    tab_v[c, pos] = v
    return tab_c, tab_v


class IC0:
    """M = L L^T, the IC(0) factor of the matrix `csr`, its values
    rounded by `rnd` as they are produced; apply(r) = M^-1 r."""

    def __init__(self, csr, device, rnd=lambda t: t):
        n, self.n, self.rnd = csr.n, csr.n, rnd
        cols, a_low, a_diag = _lower_table(csr, device)
        a_low, a_diag = rnd(a_low), rnd(a_diag)
        self.levels = _levels(cols, n)
        vals = torch.zeros_like(a_low)
        diag = torch.ones_like(a_diag)
        w = cols.shape[1]
        for rows in self.levels:
            c_r = cols[rows]
            for p in range(w):
                # L[i, k] = (A[i, k] - sum_j L[i, j] L[k, j]) / L[k, k],
                # j < k over the columns that rows i and k share.
                k = c_r[:, p]
                match = c_r[:, :p, None] == cols[k][:, None, :]
                match &= c_r[:, :p, None] < n
                s = (vals[rows, :p, None] * vals[k][:, None, :]
                     * match).sum(dim=(1, 2))
                vals[rows, p] = torch.where(
                    k < n, rnd((a_low[rows, p] - s) / diag[k]), 0.0)
            diag[rows] = rnd(torch.sqrt(
                a_diag[rows] - (vals[rows] ** 2).sum(dim=1)))
        self.cols, self.vals, self.diag = cols, vals, diag
        self.cols_t, self.vals_t = _transpose(cols, vals, n)
        # Each level's slice of the tables, gathered once.
        self.fwd = [(r, cols[r], vals[r], diag[r]) for r in self.levels]
        self.bwd = [(r, self.cols_t[r], self.vals_t[r], diag[r])
                    for r in reversed(self.levels)]

    def _sweep(self, b: torch.Tensor, plan) -> torch.Tensor:
        out = torch.zeros(self.n + 1, dtype=b.dtype, device=b.device)
        for rows, c, v, d in plan:
            out[rows] = self.rnd((b[rows] - (v * out[c]).sum(dim=1)) / d)
        return out[:self.n]

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """z = L^-T (L^-1 r)."""
        return self._sweep(self._sweep(r, self.fwd), self.bwd)
