"""Host seconds of the two level-set schedules of the IC(0) solves
(build_sts on L and on the reversed L^T, with the transpose), from the
program's build.ic0.schedule span."""

from spmv_bench.spans import phase_s


def read(run):
    return phase_s("build.ic0.schedule")
