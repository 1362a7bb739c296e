"""Host seconds of the program's reordering (reorder.rcm,
CSRMatrix.permuted, CSRkMatrix.build), from its own build.reorder spans
where no other build phase encloses them."""

from spmv_bench.spans import phase_s


def read(run):
    return phase_s("build.reorder")
