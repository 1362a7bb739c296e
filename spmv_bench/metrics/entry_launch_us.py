"""Mean host us a call of the eager entry spends in the C launch and
its return-code check (the entry.launch step) in the traced window."""

from spmv_bench.spans import step_us


def read(run):
    return step_us("entry.launch")
