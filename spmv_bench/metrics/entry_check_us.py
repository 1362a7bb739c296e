"""Mean host us a call of the eager entry spends in its checks and
argument assembly (the entry.check step) in the traced window."""

from spmv_bench.spans import step_us


def read(run):
    return step_us("entry.check")
