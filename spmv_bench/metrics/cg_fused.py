"""The share of this process's shards whose CG iteration runs as the
program's fused kernels (the ranked walk with its p.Ap epilogue, the
updates of x and r with r.r, the new p with rz), in %: 100 x
`cg.fused_shards` / `cg.local_shards`, the counters the program sets
when it builds the iteration, found by the recorder's module name, never
by importing the program; None where they are not set (a control run, a
program without them). Rank 0's reading in a cell of several cards."""

import sys

RECORDER = "tpu_spmv_torch.obs"


def read(run):
    counters = getattr(sys.modules.get(RECORDER), "counters", None)
    if counters is None:
        return None
    got = counters()
    fused = got.get("cg.fused_shards")
    local = got.get("cg.local_shards")
    if fused is None or not local:
        return None
    return 100.0 * fused / local
