"""The band's L2 reuse window of the DIA layout the run routed, over the
L2 budget the route held it to, in %: the bytes that stream through the
L2 while spmv_dia holds one entry of x between its first and its last
read (span rows x (D values + 4 B of y + 4 B of x)), against half the
card's L2. Read from the program's counters `dia.l2_window_bytes` and
`dia.l2_budget_bytes`, set once when the route is chosen and found by
the recorder's module name, never by importing the program; None where
no DIA layout was routed (a control run, another layout, a program
without the counters)."""

import sys

RECORDER = "tpu_spmv_torch.obs"


def read(run):
    counters = getattr(sys.modules.get(RECORDER), "counters", None)
    if counters is None:
        return None
    got = counters()
    window = got.get("dia.l2_window_bytes")
    budget = got.get("dia.l2_budget_bytes")
    if window is None or not budget:
        return None
    return 100.0 * window / budget
