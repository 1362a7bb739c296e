"""Spans of the port's own steps, kept in memory, in the clock of a
torch.profiler trace.

Two kinds of span:

  phase spans   `span(name)`, a context manager or a decorator, around
                the steps of a matrix's host build (plan, reorder,
                layout, transfer, factor, schedules, capture, the
                kernels' load). Always kept: they fire tens of times a
                matrix, inside builds of seconds.
  call spans    `@entry` on an eager entry (a kernel wrapper): the call
                span `entry.<its name>`, kept only while a torch profiler
                records. The entry marks each of its steps with
                `step(name)`. With no profiler a call costs one Python
                frame and one read of the profiler's module flag more,
                and a step site that one read: no clock read, no
                allocation, no record_function.

A span is kept with its id, its parent's id (the span open on the same
thread when it began; 0 for none), its name, and its start and end in
ns since the Unix epoch (time.time_ns): the clock of a chrome trace,
whose `ts` (us) plus `baseTimeNanoseconds` / 1000 is Unix-epoch us.
While a profiler records, each phase span and each call also enters its
trace as a `_RecordFunctionFast` (or `record_function` where torch lacks
it) named `tpu_spmv_torch.<name>`, so the trace names the port's steps
where it would otherwise show bare Python. A call's steps are clock
stamps kept in the call, its children in `spans()`, and enter no trace:
one profiler event a call keeps a traced call's cost near an untraced
one's.

Phase spans and calls are kept in two stores, each keeping its newest
entries and counting those it dropped, so a traced window's calls never
push out a build's phases. `spans()` returns what they hold, `reset()`
clears them. The recorder has no exporter and no file output, and reads
no environment variable.

Beside the spans, a small store of counters: named numbers a kernel
wrapper sets for what its last call did (`set_counters`, a dict update
a call), or a route decision for the layout it chose (kernels/dia.
dia_route, once a layout), read with `counters()` and cleared by
`reset()`.
"""

from __future__ import annotations

import collections
import functools
import itertools
import threading
import time
import typing

import torch
from torch.autograd import profiler as _profiler

try:
    _RecordFunction = torch._C._profiler._RecordFunctionFast
except AttributeError:
    _RecordFunction = torch.profiler.record_function

PHASE_CAPACITY = 1 << 16
CALL_CAPACITY = 1 << 17
PREFIX = "tpu_spmv_torch."
BUILD = "build."


class Span(typing.NamedTuple):
    id: int
    parent: int  # 0: no span was open on the thread when it began
    name: str
    start_ns: int
    end_ns: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class Dropped(typing.NamedTuple):
    phases: int
    calls: int


class _Store:
    """The newest `capacity` records, and a count of all kept (a plain
    int: a count is lost only where two threads keep one at once)."""

    def __init__(self, capacity: int):
        self.held = collections.deque(maxlen=capacity)
        self.kept = 0

    def keep(self, record) -> None:
        self.held.append(record)
        self.kept += 1

    def dropped(self) -> int:
        return self.kept - len(self.held)

    def clear(self) -> None:
        self.held.clear()
        self.kept = 0


class Recorder:
    """The store of phase spans and the store of calls, each a record
    (id, parent, name, start, end, steps) with its steps' (id, name,
    start) stamps."""

    def __init__(self, phase_capacity: int = PHASE_CAPACITY,
                 call_capacity: int = CALL_CAPACITY):
        self.phases = _Store(phase_capacity)
        self.calls = _Store(call_capacity)

    def spans(self) -> list:
        out = list(self.phases.held)
        for cid, parent, name, start, end, steps in list(self.calls.held):
            out.append(Span(cid, parent, name, start, end))
            for i, (sid, step, t) in enumerate(steps, 1):
                out.append(Span(sid, cid, step, t,
                                steps[i][2] if i < len(steps) else end))
        return out


class _Open:
    """A thread's open spans: their ids, innermost last, and the step
    stamps of its innermost open call (None outside calls)."""

    __slots__ = ("stack", "steps")

    def __init__(self):
        self.stack = []
        self.steps = None


class _Local(threading.local):
    # One thread-local read a call or step; the rest are slot reads.
    def __init__(self):
        self.open = _Open()


RECORDER = Recorder()
_COUNTERS: dict = {}
_ids = itertools.count(1)
_local = _Local()


class span:
    """A phase span: `with span("build.layout"):` or, on a function,
    `@span("build.layout")`. Kept always; entered into a recording
    profiler's trace too."""

    __slots__ = ("name", "record")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        self.record = _begin(self.name)

    def __exit__(self, *exc) -> None:
        _end(self.record)

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            record = _begin(name)
            try:
                return fn(*args, **kwargs)
            finally:
                _end(record)

        return spanned


def _begin(name: str) -> tuple:
    stack = _local.open.stack
    sid = next(_ids)
    parent = stack[-1] if stack else 0
    event = None
    if _profiler._is_profiler_enabled:
        event = _RecordFunction(PREFIX + name)
        event.__enter__()
    stack.append(sid)
    return sid, parent, name, event, time.time_ns()


def _end(record: tuple) -> None:
    end = time.time_ns()
    sid, parent, name, event, start = record
    _local.open.stack.pop()
    if event is not None:
        event.__exit__(None, None, None)
    RECORDER.phases.keep(Span(sid, parent, name, start, end))


def entry(fn):
    """An eager entry `fn(layout, x, ...)` in its call span
    `entry.<its name>`, kept while a torch profiler records: one profiler
    event, and the stamps of the steps that `fn` marks with step(). A
    call's span starts after its event begins and ends before it ends,
    so it leaves the event's own cost out."""
    name = "entry." + fn.__name__
    event_name = PREFIX + name

    @functools.wraps(fn)
    def spanned(layout, x, *rest, **kwargs):
        if not _profiler._is_profiler_enabled:
            # The plain call when there is nothing more to pass: a tenth
            # of a microsecond less than forwarding empty *rest, **kwargs.
            if rest or kwargs:
                return fn(layout, x, *rest, **kwargs)
            return fn(layout, x)
        opened = _local.open
        stack = opened.stack
        cid = next(_ids)
        parent = stack[-1] if stack else 0
        outer = opened.steps
        steps = opened.steps = []
        event = _RecordFunction(event_name)
        event.__enter__()
        stack.append(cid)
        start = time.time_ns()
        try:
            return fn(layout, x, *rest, **kwargs)
        finally:
            end = time.time_ns()
            stack.pop()
            opened.steps = outer
            event.__exit__(None, None, None)
            RECORDER.calls.keep((cid, parent, name, start, end,
                                 tuple(steps)))

    return spanned


def step(name: str) -> None:
    """Begins step `name` of this thread's innermost open call, ending
    the step before it; nothing while no profiler records, or outside a
    call."""
    if _profiler._is_profiler_enabled:
        steps = _local.open.steps
        if steps is not None:
            steps.append((next(_ids), name, time.time_ns()))


def spans() -> list:
    """The finished spans held: the phase spans in the order they
    ended, then each call followed by its steps, in the order the calls
    ended."""
    return RECORDER.spans()


def dropped() -> Dropped:
    """Phase spans and calls dropped since the last reset because their
    store was full."""
    return Dropped(RECORDER.phases.dropped(), RECORDER.calls.dropped())


def set_counters(values: dict) -> None:
    """Sets each counter named in `values` to its value (the last call's
    reading, not a running total)."""
    _COUNTERS.update(values)


def counters() -> dict:
    """A copy of the counters set since the last reset."""
    return dict(_COUNTERS)


def reset() -> None:
    RECORDER.phases.clear()
    RECORDER.calls.clear()
    _COUNTERS.clear()


def mark() -> int:
    """An id below every span opened from now on: `phase_seconds(since=
    mark())` then sums only what follows."""
    return next(_ids)


def phase_seconds(since: int = 0) -> float:
    """Seconds of the build phases with id >= since that no build phase
    encloses: each instant of a nested build counted once, by its
    outermost phase."""
    held = [s for s in RECORDER.phases.held if s.id >= since]
    build = {s.id for s in held if s.name.startswith(BUILD)}
    up = {s.id: s.parent for s in held}
    up.update((c[0], c[1]) for c in RECORDER.calls.held if c[0] >= since)

    def enclosed(p: int) -> bool:
        while p:
            if p in build:
                return True
            p = up.get(p, 0)
        return False

    return sum(s.seconds for s in held
               if s.id in build and not enclosed(s.parent))
