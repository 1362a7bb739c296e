"""Reordering layer: RCM, coarsening, permutation composition.

The port's copy of `tpu_spmv.reorder`, held equal to it by
tests/test_torch_host.py. Algorithms have two semantics-identical
implementations: vectorized NumPy (reference/testing, reorder/{rcm,
coarsen}.py) and the C++ native core (reorder/csrc/reorder.cc via
ctypes), selected by `backend`: 'auto' prefers native when the shared
library is available.
"""

import numpy as np

from tpu_spmv_torch import obs
from tpu_spmv_torch.reorder import native
from tpu_spmv_torch.reorder.coarsen import hand_coarsen as _np_hand_coarsen
from tpu_spmv_torch.reorder.coarsen import matching_coarsen  # noqa: F401
from tpu_spmv_torch.reorder.compose import uncoarsen_compose  # noqa: F401
from tpu_spmv_torch.reorder.rcm import bandwidth, cuthill_mckee  # noqa: F401
from tpu_spmv_torch.reorder.rcm import rcm as _np_rcm


@obs.span("build.reorder")
def rcm(indptr, indices, edge_weights=None, backend="auto", **kwargs):
    """Reverse Cuthill-McKee permutation (new->old). backend: auto|native|numpy."""
    if backend == "auto":
        backend = "native" if (not kwargs and native.available()) else "numpy"
    if backend == "native":
        return native.rcm(indptr, indices, edge_weights)
    return _np_rcm(indptr, indices, edge_weights, **kwargs)


def hand_coarsen(indptr, indices, nnz_budget, edge_weights=None, backend="auto"):
    """Contiguous nnz-budget coarsening; see reorder.coarsen.hand_coarsen."""
    if backend == "auto":
        backend = "native" if native.available() else "numpy"
    if backend == "native":
        from tpu_spmv_torch.reorder.coarsen import _group_graph

        map_ptr = native.hand_coarsen_boundaries(indptr, int(nnz_budget))
        n = np.asarray(indptr).shape[0] - 1
        group_of = np.zeros(n, dtype=np.int64)
        group_of[map_ptr[1:-1]] = 1
        group_of = np.cumsum(group_of)
        coarse = _group_graph(
            group_of, map_ptr.shape[0] - 1,
            np.asarray(indptr, dtype=np.int64),
            np.asarray(indices, dtype=np.int64),
            edge_weights,
        )
        return map_ptr, coarse
    return _np_hand_coarsen(indptr, indices, nnz_budget, edge_weights)
