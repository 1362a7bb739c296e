"""Host seconds of the first load of the program's kernel library (the
stale check, any nvcc build, the dlopen, the signatures), from its own
build.kernels span."""

from spmv_bench.spans import phase_s


def read(run):
    return phase_s("build.kernels")
