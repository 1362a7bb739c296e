"""Reverse Cuthill-McKee reordering with pseudo-peripheral root finding.

Fresh implementation of the George-Liu GPS-style algorithm used by the
reference's CSR-k preprocessing (reference: rcm_reordering_g
spmv-csrk/csrk.cpp:2289-2374, findPseudoPeripheralVertex /
findRootedLevelStructures csrk.cpp:2377-2475).

Differences by design (documented, not accidental):
  * neighbor visit order is a *stable* sort by (descending edge weight,
    ascending vertex degree, ascending id); the reference uses an unstable
    std::sort descending on edge weight only (compare_rev_deg_id_pair,
    csrk.cpp:65-67), so its tie order is unspecified. Any valid CM order
    yields equivalent bandwidth properties.
  * operates per connected component like the reference's mask loop
    (csrk.cpp:919-933).

The fast path for large graphs is the C++ core (reorder/csrc/reorder.cc);
this module is the reference/NumPy implementation used for coarse graphs
and property testing.
"""

from __future__ import annotations

import numpy as np


def bandwidth(indptr: np.ndarray, indices: np.ndarray) -> int:
    """Maximum |i - j| over stored entries (matrix bandwidth)."""
    m = indptr.shape[0] - 1
    if indices.size == 0:
        return 0
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(indptr))
    return int(np.abs(rows - indices.astype(np.int64)).max())


def _level_structure(root: int, indptr, indices, component_mask):
    """BFS level structure rooted at root, restricted to unvisited vertices.

    Returns (levels list of arrays, visited bool array over graph).
    Mirrors findRootedLevelStructures (csrk.cpp:2426-2475) with frontier
    arrays instead of an explicit queue.
    """
    visited = ~component_mask  # vertices outside the component count as seen
    visited = visited.copy()
    visited[root] = True
    frontier = np.array([root], dtype=np.int64)
    levels = [frontier]
    while True:
        # All neighbors of the frontier.
        starts = indptr[frontier]
        ends = indptr[frontier + 1]
        if len(frontier) == 0:
            break
        neigh = np.concatenate(
            [indices[s:e] for s, e in zip(starts, ends)]
        ) if len(frontier) else np.zeros(0, dtype=indices.dtype)
        neigh = np.unique(neigh[~visited[neigh]])
        if neigh.size == 0:
            break
        visited[neigh] = True
        levels.append(neigh.astype(np.int64))
        frontier = levels[-1]
    return levels, visited


def _pseudo_peripheral(root: int, indptr, indices, component_mask):
    """Iterate rooted level structures, re-rooting at a minimum-degree vertex
    of the deepest level until eccentricity stops growing
    (findPseudoPeripheralVertex, csrk.cpp:2377-2423)."""
    levels, _ = _level_structure(root, indptr, indices, component_mask)
    cc_size = sum(len(l) for l in levels)
    if len(levels) == 1 or len(levels) == cc_size:
        return root, levels
    degrees = np.diff(indptr)
    while True:
        last = levels[-1]
        cand = last[np.argmin(degrees[last])]
        new_levels, _ = _level_structure(int(cand), indptr, indices, component_mask)
        if len(new_levels) <= len(levels):
            return root, levels
        root, levels = int(cand), new_levels
        if len(levels) >= cc_size:
            return root, levels


def cuthill_mckee(
    indptr: np.ndarray,
    indices: np.ndarray,
    edge_weights: np.ndarray | None = None,
) -> np.ndarray:
    """Cuthill-McKee ordering (new->old), all connected components.

    Neighbor visit order: stable sort by (-edge_weight, vertex_degree, id).
    With edge_weights=None this is classic CM by ascending degree.
    """
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    m = indptr.shape[0] - 1
    degrees = np.diff(indptr)
    unvisited = np.ones(m, dtype=bool)
    order = np.empty(m, dtype=np.int64)
    pos = 0

    # Component roots are taken in ascending id, like the mask scan in
    # preprocessingForSpMV (csrk.cpp:919-933).
    for start in range(m):
        if not unvisited[start]:
            continue
        root, _ = _pseudo_peripheral(start, indptr, indices, unvisited)
        # BFS with sorted neighbor insertion.
        unvisited[root] = False
        order[pos] = root
        head = pos
        pos += 1
        while head < pos:
            v = order[head]
            head += 1
            s, e = indptr[v], indptr[v + 1]
            neigh = indices[s:e]
            sel = unvisited[neigh]
            if not sel.any():
                continue
            cand = neigh[sel]
            if edge_weights is not None:
                w = edge_weights[s:e][sel]
                key = np.lexsort((cand, degrees[cand], -w))
            else:
                key = np.lexsort((cand, degrees[cand]))
            cand = cand[key]
            # The same vertex may appear once per parallel edge; dedupe
            # while preserving the first occurrence order.
            _, first = np.unique(cand, return_index=True)
            cand = cand[np.sort(first)]
            unvisited[cand] = False
            order[pos : pos + cand.size] = cand
            pos += cand.size
    assert pos == m, "graph traversal must visit every vertex"
    return order


def rcm(
    indptr: np.ndarray,
    indices: np.ndarray,
    edge_weights: np.ndarray | None = None,
    reverse_per_component: bool = True,
) -> np.ndarray:
    """Reverse Cuthill-McKee permutation (new->old).

    The reference reverses each connected component in place within the
    global order (rcm_reordering_g's mid-swap loop, csrk.cpp:2352-2368);
    with reverse_per_component=False the whole order is reversed instead.
    """
    order = cuthill_mckee(indptr, indices, edge_weights)
    if not reverse_per_component:
        return order[::-1].copy()
    # Reverse each component's slice. Recover component boundaries by
    # walking the order with a visited set is unnecessary: recompute sizes
    # via BFS labeling.
    comp = _component_labels(indptr, indices)
    out = np.empty_like(order)
    comp_of_order = comp[order]
    # Order visits components consecutively; find run boundaries.
    boundaries = np.flatnonzero(np.diff(comp_of_order) != 0) + 1
    pieces = np.split(order, boundaries)
    offset = 0
    for p in pieces:
        out[offset : offset + p.size] = p[::-1]
        offset += p.size
    return out


def _component_labels(indptr, indices) -> np.ndarray:
    m = indptr.shape[0] - 1
    labels = np.full(m, -1, dtype=np.int64)
    current = 0
    for start in range(m):
        if labels[start] >= 0:
            continue
        frontier = np.array([start], dtype=np.int64)
        labels[start] = current
        while frontier.size:
            neigh = np.concatenate(
                [indices[indptr[v] : indptr[v + 1]] for v in frontier]
            )
            neigh = np.unique(neigh)
            neigh = neigh[labels[neigh] < 0]
            labels[neigh] = current
            frontier = neigh
        current += 1
    return labels
