"""The distributed layer of the port: row-sharded SpMV/SpMM with the
halo exchange and its overlap (sharding.py), and CG / Jacobi-PCG over
them (solvers.py); the counterpart of `tpu_spmv.dist`.

The sharded triangular solve (`ShardedLowerSolve`, `sts_solve_sharded`)
is not ported yet (ROADMAP.md item A13c)."""

from tpu_spmv_torch.dist.sharding import (  # noqa: F401
    OverlapRanked, ShardedRanked, ShardedSell, make_row_mesh,
    spmm_overlap, spmm_sharded, spmv_overlap, spmv_sharded,
)
from tpu_spmv_torch.dist.solvers import cg_solve, pcg_solve  # noqa: F401


def __getattr__(name):
    if name in ("ShardedLowerSolve", "sts_solve_sharded"):
        raise AttributeError(
            f"{name}: the sharded triangular solve is not ported to the GPU "
            "yet (ROADMAP.md item A13c)")
    raise AttributeError(name)
