"""Host seconds of the two solve layouts of the IC(0) preconditioner
(LowerSolveLayout.build twice, their transfer included), from the
program's build.ic0.layout span."""

from spmv_bench.spans import phase_s


def read(run):
    return phase_s("build.ic0.layout")
