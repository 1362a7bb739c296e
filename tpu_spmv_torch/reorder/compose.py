"""Multilevel permutation composition (the 'uncoarsen' pass).

Given per-level coarse-to-fine group maps and per-level RCM permutations,
compose them top-down into a single fine-level permutation plus final
group maps — the reference's uncoarsen loop
(BAND_k::uncoarsenTheGraph, spmv-csrk/csrk.cpp:1148-1224, driven from
preprocessingForSpMV csrk.cpp:1015-1034).
"""

from __future__ import annotations

import numpy as np


def _expand_groups(map_ptr: np.ndarray, coarse_perm: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Reorder contiguous groups by a coarse permutation.

    Returns (new_map_ptr, fine_perm) where fine_perm (new->old over the
    fine ids of this level) concatenates the old groups in coarse_perm
    order, and new_map_ptr is the prefix sum of reordered group lengths.
    """
    lengths = np.diff(map_ptr)
    new_lengths = lengths[coarse_perm]
    new_map_ptr = np.zeros(map_ptr.shape[0], dtype=np.int64)
    np.cumsum(new_lengths, out=new_map_ptr[1:])
    n_fine = int(map_ptr[-1])
    fine_perm = np.empty(n_fine, dtype=np.int64)
    starts = map_ptr[coarse_perm]
    # Scatter each old range into its new contiguous position.
    pos = 0
    for g in range(coarse_perm.shape[0]):
        ln = new_lengths[g]
        fine_perm[pos : pos + ln] = np.arange(starts[g], starts[g] + ln)
        pos += ln
    return new_map_ptr, fine_perm


def uncoarsen_compose(
    maps: list[np.ndarray],
    coarse_perms: list[np.ndarray],
    n_fine: int,
) -> tuple[np.ndarray, list[np.ndarray]]:
    """Compose k-1 levels of coarsening maps and coarse permutations.

    Args:
      maps: maps[i] (i=0..k-2) is the (n_{i+1}+1,) group pointer from
        level-(i+1) super-rows onto level-i vertex ranges, in the level-i
        numbering *after* level-i's own reordering (pre level-(i+1) RCM
        coarse numbering) — exactly what hand_coarsen returns at each level.
      coarse_perms: coarse_perms[i] is the RCM new->old permutation of the
        level-(i+1) graph.
      n_fine: number of level-0 vertices.

    Returns:
      (perm, final_maps): perm is the level-0 new->old permutation
      (the reference's permBigG), and final_maps[i] the group pointer of
      level-(i+1) super-rows over the *final* level-i numbering.
    """
    k_minus_1 = len(maps)
    if len(coarse_perms) != k_minus_1:
        raise ValueError("maps and coarse_perms must have equal length")
    # Working composed permutation per level; levels 1..k-1 start at their
    # RCM perms, level 0 at identity (graphPermutations[0], csrk.cpp:887-891).
    perms = [np.arange(n_fine, dtype=np.int64)] + [
        np.asarray(p, dtype=np.int64) for p in coarse_perms
    ]
    final_maps: list[np.ndarray | None] = [None] * k_minus_1
    for i in range(k_minus_1 - 1, -1, -1):
        new_map_ptr, fine_perm = _expand_groups(
            np.asarray(maps[i], dtype=np.int64), perms[i + 1]
        )
        final_maps[i] = new_map_ptr
        perms[i] = perms[i][fine_perm]
    return perms[0], final_maps
