"""Host seconds of the IC(0) factorization inside
IC0Preconditioner.build, from the program's build.ic0.factor span."""

from spmv_bench.spans import phase_s


def read(run):
    return phase_s("build.ic0.factor")
