"""The distributed layer of the port: row-sharded SpMV/SpMM with the
halo exchange and its overlap (sharding.py), CG / Jacobi-PCG over them
(solvers.py), the sharded triangular solve (sts.py), the (hosts, rows)
mesh and the process group (multihost.py) and the exchange between
processes (group.py); the counterpart of `tpu_spmv.dist`."""

from tpu_spmv_torch.dist.sharding import (  # noqa: F401
    OverlapRanked, ShardedRanked, ShardedSell, make_row_mesh,
    spmm_overlap, spmm_sharded, spmv_overlap, spmv_sharded,
)
from tpu_spmv_torch.dist.solvers import cg_solve, pcg_solve  # noqa: F401
from tpu_spmv_torch.dist.sts import (  # noqa: F401
    ShardedLowerSolve, sts_solve_sharded,
)
