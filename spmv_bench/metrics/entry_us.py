"""Mean host us of one call of the program's eager SpMV entry (its
kernel wrapper's entry.<wrapper> span) in the traced window."""

from spmv_bench.spans import call_us


def read(run):
    return call_us()
