"""Host seconds of the program's moves of its layouts to the card
(TensorLayout.to, ShardedRanked.device_put), from its own
build.to_device spans where no other build phase encloses them."""

from spmv_bench.spans import phase_s


def read(run):
    return phase_s("build.to_device")
