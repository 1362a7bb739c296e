"""The trace reader keeps every device operation's time by name, so a
reader of a few kernels (the collectives of comm_us) does not depend on
their place among the breakdown's ten longest."""

import types

import pytest

from spmv_bench import run as harness
from spmv_bench import trace


def _events():
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW,
           "ts": 0.0, "dur": 1000.0}]
    t = 0.0
    for i in range(12):  # kernel k<i> of 60 - i us, one after another
        ev.append({"ph": "X", "cat": "kernel", "name": f"k{i:02d}",
                   "ts": t, "dur": 60.0 - i})
        t += 60.0 - i
    for ts in (700.0, 800.0):  # two 5 us collectives
        ev.append({"ph": "X", "cat": "kernel", "ts": ts, "dur": 5.0,
                   "name": "ncclDevKernel_AllGather_RING_LL(args)"})
    return ev


def test_every_name_is_kept_and_the_breakdown_is_the_top_ten():
    t = trace.summarize(_events())
    assert [k for k, _ in t.device_ops] == [f"k{i:02d}" for i in range(10)]
    assert t.device_s_of("nccl") == pytest.approx(10e-6)
    assert t.device_s_of("k") == pytest.approx(sum(60 - i for i in range(12))
                                               * 1e-6)
    assert t.device_s == pytest.approx(t.device_s_of(""))
    assert t.n_device_ops == 14


def test_comm_us_reads_the_collectives_an_iteration():
    read = harness.reader("comm_us.cg_x4")
    run = types.SimpleNamespace(trace=trace.summarize(_events()),
                                counts={"traced_iters": 4})
    assert read(run) == pytest.approx(2.5)
    run.counts = {}
    assert read(run) is None
    run.counts, run.trace = {"traced_iters": 4}, None
    assert read(run) is None
