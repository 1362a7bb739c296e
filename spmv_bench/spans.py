"""The program's own spans, read from its recorder: the module
`tpu_spmv_torch.obs`, where the run loaded it. The benchmark never
imports the program for it: a run without the recorder (a control run,
or a program that has none) reads None, and so does a run whose
recorder holds no span of the kind asked for.

Each span carries `id`, `parent` (the span open on its thread when it
began, 0 for none), `name`, `start_ns` and `end_ns`.

- A build phase is a span named "build.<...>". A phase's seconds count
  only its spans that no build phase encloses: where phases nest, the
  outer one owns the time, so a run's phases are disjoint and add up.
  Where the recorder dropped phase spans (its store was full), a
  phase's sum would be partial, and it reads None.
- A call is a span named "entry.<wrapper>" (not a step) that no other
  call encloses: one call of an eager entry. The program keeps call
  spans only while a profiler records, so they are the traced window's.
- A step ("entry.check", "entry.alloc", "entry.launch") is read per
  call: the seconds of the steps of those calls, over the calls."""

from __future__ import annotations

import sys

RECORDER = "tpu_spmv_torch.obs"
STEPS = ("entry.check", "entry.alloc", "entry.launch")


def held():
    """The recorder's spans, or None where the run has no recorder."""
    obs = sys.modules.get(RECORDER)
    spans = getattr(obs, "spans", None)
    return None if spans is None else list(spans())


def phases_dropped() -> bool:
    """Whether the recorder says it dropped phase spans."""
    dropped = getattr(sys.modules.get(RECORDER), "dropped", None)
    return dropped is not None and dropped().phases > 0


def _enclosed(s, by: dict, pred) -> bool:
    p = s.parent
    while p in by:
        if pred(by[p]):
            return True
        p = by[p].parent
    return False


def _phase(s) -> bool:
    return s.name.startswith("build.")


def _call(s) -> bool:
    return s.name.startswith("entry.") and s.name not in STEPS


def phase_s(name: str):
    """Seconds of the phase `name`, counted where no build phase
    encloses it; None where the recorder holds no such span."""
    spans = held()
    if spans is None or phases_dropped():
        return None
    by = {s.id: s for s in spans}
    mine = [s for s in spans
            if s.name == name and not _enclosed(s, by, _phase)]
    if not mine:
        return None
    return sum(s.end_ns - s.start_ns for s in mine) * 1e-9


def calls(spans):
    """The outermost call spans of `spans`, or None for None."""
    if spans is None:
        return None
    by = {s.id: s for s in spans}
    return [s for s in spans if _call(s) and not _enclosed(s, by, _call)]


def call_us():
    """Mean us of a call; None without calls."""
    outer = calls(held())
    if not outer:
        return None
    return sum(s.end_ns - s.start_ns for s in outer) / len(outer) * 1e-3


def step_us(step: str):
    """Mean us a call spends in `step` (0 in a call without it); None
    without calls, or where no call has the step."""
    spans = held()
    outer = calls(spans)
    if not outer:
        return None
    ids = {s.id for s in outer}
    mine = [s for s in spans if s.name == step and s.parent in ids]
    if not mine:
        return None
    return sum(s.end_ns - s.start_ns for s in mine) / len(outer) * 1e-3
