"""The device trace of a short window: torch.profiler's chrome trace,
read back into the device's busy time, kernel time by name, and idle
gaps by what the host was doing.

busy_s is the union of the device's operations (kernels, copies, sets)
inside the window; window_s is the window's own span, a host annotation
that ends after the device has drained, in the trace's clock.
device_by_name holds every device operation's seconds by its name, for
the readers (device_ops, the breakdown, keeps the TOP of them). An idle
gap is labelled by the innermost host event (an operator, a runtime
call or a harness annotation) that covers its midpoint, "python" where
none does; the gaps' seconds are summed by label."""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import tempfile

WINDOW = "spmv_bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10
LOOKBACK = 32


@dataclasses.dataclass
class Trace:
    busy_s: float
    window_s: float
    device_s: float
    device_ops: list
    idle_gaps: list
    n_device_ops: int
    device_by_name: dict = dataclasses.field(default_factory=dict)

    def device_s_of(self, prefix: str) -> float:
        """Device seconds of the operations whose name starts with
        prefix."""
        return sum(v for k, v in self.device_by_name.items()
                   if k.startswith(prefix))


def profile(body, device) -> tuple[object, Trace]:
    """Runs body() under the profiler, inside the WINDOW annotation, and
    synchronizes before the annotation ends. Returns (body's result,
    Trace). The chrome trace is written to a temporary file in TMPDIR
    and removed once read."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with record_function(WINDOW):
            out = body()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return out, summarize(events)


def summarize(events: list) -> Trace:
    spans = [e for e in events if e.get("ph") == "X"]
    win = [e for e in spans if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError(f"the trace holds no {WINDOW} annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                 for e in spans if e.get("cat") in DEVICE_CATS)
    by_name = collections.Counter()
    busy, gaps, cur0, cur1 = 0.0, [], w0, w0
    for a, b, name in dev:
        by_name[name] += (b - a) * 1e-6
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        if a > cur1:
            busy += cur1 - cur0
            gaps.append((cur1, a))
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    busy += cur1 - cur0
    if w1 > cur1:
        gaps.append((cur1, w1))
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                  for e in spans if e.get("cat") in HOST_CATS
                  and e.get("name") != WINDOW)
    starts = [h[0] for h in host]
    idle = collections.Counter()
    for a, b in gaps:
        idle[_label(host, starts, (a + b) / 2)] += (b - a) * 1e-6
    return Trace(busy_s=busy * 1e-6, window_s=(w1 - w0) * 1e-6,
                 device_s=sum(by_name.values()),
                 device_ops=[[k, v] for k, v in by_name.most_common(TOP)],
                 idle_gaps=[[k, v] for k, v in idle.most_common(TOP)],
                 n_device_ops=len(dev), device_by_name=dict(by_name))


def _label(host: list, starts: list, t: float) -> str:
    """The innermost host event covering time t: of those that started
    before t and have not ended, the one that started last."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - LOOKBACK, -1), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "python"
