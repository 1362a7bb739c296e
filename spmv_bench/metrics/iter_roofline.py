"""Least time of the traced window's solves (their iterations and their
starts, spmv_bench.roofline) over the device time of their operations
in the trace, in %."""


def read(run):
    t = run.trace
    if t is None or not t.n_device_ops or run.traced_work is None:
        return None
    return 100.0 * run.traced_work.least_s / t.device_s
