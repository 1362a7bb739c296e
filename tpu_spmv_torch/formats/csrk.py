"""CSR-k multilevel matrix: coarsen + per-level RCM + reorder.

TPU-first re-expression of the reference's CSRk_Graph / BAND_k pipeline
(reference: CSRk_Graph csrk.h:253-345, putInCSRkFormat csrk.cpp:681-706,
BAND_k::preprocessingForSpMV csrk.cpp:841-1067). The host side builds:

  * permutation (new->old over original rows, the reference's permBigG),
  * level maps: maps[i] points from level-(i+1) super-rows to contiguous
    level-i row ranges in the final numbering (mapCoarseToFinerRows),
  * the symmetrically permuted matrix with per-row sorted columns.

The port's copy of `tpu_spmv.formats.csrk`, held equal to it by
tests/test_torch_host.py. The permuted matrix feeds the slab layouts
(formats/sell.py). k=1 means plain CSR (no hierarchy).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpu_spmv_torch import obs
from tpu_spmv_torch.formats.csr import CSRMatrix
from tpu_spmv_torch import reorder
from tpu_spmv_torch.reorder.coarsen import WeightedGraph, matching_coarsen
from tpu_spmv_torch.reorder.compose import uncoarsen_compose


@dataclasses.dataclass
class CSRkMatrix:
    """A symmetrically permuted CSR matrix plus its super-row hierarchy."""

    matrix: CSRMatrix  # permuted matrix (rows/cols relabeled, rows sorted)
    perm: np.ndarray  # (m,) new->old row permutation (permBigG)
    maps: list  # maps[i]: (n_{i+1}+1,) level-(i+1) -> level-i pointers
    k: int
    sup_row_sizes: tuple

    @property
    def num_coarsest_rows(self) -> int:
        return int(self.maps[-1].shape[0] - 1) if self.maps else self.matrix.m

    def level_map(self, level: int) -> np.ndarray:
        """Group pointer of level `level` (1-based like the reference)."""
        return self.maps[level - 1]

    def set_x(self, x: np.ndarray) -> np.ndarray:
        """Permute x into the matrix ordering (CSRk_Graph::setX, csrk.h:327).

        The permutation is symmetric (columns relabeled with rows) only
        for square matrices; rectangular inputs relabel rows only, so x
        (which lives in column space, length n != m) passes through
        unchanged — indexing it by the m-length row perm would silently
        TRUNCATE it (review r5, found via the wide-matrix sweep test)."""
        x = np.asarray(x, dtype=np.float32)
        if x.shape[0] != self.perm.shape[0]:
            return x
        return x[self.perm]

    def unpermute_y(self, y: np.ndarray) -> np.ndarray:
        """Scatter a result computed in permuted order back to original order."""
        out = np.empty_like(y)
        out[self.perm] = y
        return out

    def spmv_host(self, x: np.ndarray) -> np.ndarray:
        """Host oracle in permuted space: y_perm = (P A P^T) (P x)."""
        return self.matrix.matvec(self.set_x(x))

    def validate(self, y_perm: np.ndarray, x: np.ndarray, original: CSRMatrix,
                 tol: float = 0.01) -> int:
        """Reference validation protocol: count |y[i] - y_serial[perm[i]]| > tol
        (spmv-csrk/spmv.cpp:197-211), with the magnitude-aware scale of
        bench.harness.validate (identical for O(1) entries; relative-tol
        beyond — fp32 summation noise alone trips a pure absolute 0.01
        once |y| reaches ~1e5, see the r5 fem_1m postmortem)."""
        y_serial = original.matvec(x)[self.perm]
        scale = np.maximum(1.0, np.abs(y_serial))
        return int(np.sum(np.abs(y_perm - y_serial) > tol * scale))

    @classmethod
    @obs.span("build.reorder")
    def build(
        cls,
        mat: CSRMatrix,
        k: int = 2,
        sup_row_sizes: tuple = (),
        coarsen_type: str = "hand",
        seed: int = 0,
    ) -> "CSRkMatrix":
        """Build CSR-k: k-1 rounds of coarsen+RCM, composed top-down.

        sup_row_sizes[i] is the requested rows-per-super-row at level i+1;
        the nnz budget is sup_row_sizes[i] * nnz_i / n_i like the reference
        (csrk.cpp:896-901).
        """
        if k < 1:
            raise ValueError("k must be >= 1")
        if len(sup_row_sizes) != k - 1:
            raise ValueError(f"need {k - 1} super-row sizes for k={k}")
        if k == 1:
            return cls(
                matrix=mat,
                perm=np.arange(mat.m, dtype=np.int64),
                maps=[],
                k=1,
                sup_row_sizes=(),
            )

        g = WeightedGraph.from_csr(mat.indptr, mat.indices)
        maps: list[np.ndarray] = []
        coarse_perms: list[np.ndarray] = []
        pre_perm = None  # applied to the fine matrix before grouping (matching)

        for i in range(1, k):
            budget_rows = int(sup_row_sizes[i - 1])
            if coarsen_type == "hand":
                nnz_budget = budget_rows * g.nnz // max(g.n, 1)
                map_ptr, coarse = reorder.hand_coarsen(
                    g.indptr, g.indices, nnz_budget, g.edge_weights
                )
            elif coarsen_type in ("random", "heavy", "light"):
                # Matching does not preserve contiguity: the fine level must
                # first be permuted so each coarse vertex's members are
                # contiguous (the reference composes this in
                # matchingUncoarsenTheGraph, csrk.cpp:1070-1142).
                order, map_ptr, coarse = matching_coarsen(
                    g.indptr,
                    g.indices,
                    target_size=max(g.n // max(budget_rows, 1), 1),
                    mode=coarsen_type,
                    seed=seed + i,
                )
                g = g.renumbered(order)
                if i == 1:
                    pre_perm = order
                else:
                    # Fold into the previous level's coarse perm.
                    coarse_perms[-1] = coarse_perms[-1][order]
            else:
                raise ValueError(f"unknown coarsen_type {coarsen_type!r}")

            cperm = reorder.rcm(coarse.indptr, coarse.indices, coarse.edge_weights)
            coarse = coarse.renumbered(cperm)
            maps.append(map_ptr)
            coarse_perms.append(cperm)
            g = coarse

        perm, final_maps = uncoarsen_compose(maps, coarse_perms, mat.m)
        if pre_perm is not None:
            perm = pre_perm[perm]
        permuted = mat.permuted(perm)
        return cls(
            matrix=permuted,
            perm=perm,
            maps=final_maps,
            k=k,
            sup_row_sizes=tuple(sup_row_sizes),
        )
