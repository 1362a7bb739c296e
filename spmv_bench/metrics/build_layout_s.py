"""Host seconds of the program's layout builds (each format's from_csr,
ShardedRanked.build), from its own build.layout spans where no other
build phase encloses them."""

from spmv_bench.spans import phase_s


def read(run):
    return phase_s("build.layout")
