"""Entries of x that one call of the windowed DIA kernel copies into
shared memory over all its CTAs, over the rows n: about 1 for one ring,
about one a segment where the ring is cut into segments. Read from the
program's counter `dia.x_staged_floats`, found by the recorder's module
name, never by importing the program; None where the run has no such
counter (a control run, a resident kernel, a program without the
counters). The counter is the launch plan's count of what the kernel
stages, worked out on the host from the ring, the rows and the CTAs, not
a count the kernel keeps: it moves with the plan, not with the device."""

import sys

RECORDER = "tpu_spmv_torch.obs"


def read(run):
    counters = getattr(sys.modules.get(RECORDER), "counters", None)
    if counters is None:
        return None
    staged = counters().get("dia.x_staged_floats")
    n = run.config.get("n")
    if staged is None or not n:
        return None
    return staged / n
