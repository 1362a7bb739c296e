"""Mean host us a call of the eager entry spends allocating y and any
scratch (the entry.alloc step) in the traced window."""

from spmv_bench.spans import step_us


def read(run):
    return step_us("entry.alloc")
