"""Host seconds of the program's CUDA-graph capture of a solver
iteration, its eager warm-up step included, from its own build.capture
spans."""

from spmv_bench.spans import phase_s


def read(run):
    return phase_s("build.capture")
