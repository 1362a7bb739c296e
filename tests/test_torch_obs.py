"""The port's span recorder (tpu_spmv_torch/obs.py) and the spans its
build phases and kernel wrappers record.

CPU tests hold the recorder (nesting, parents, self time, the bounded
store, the profiler's clock), the wrappers' cost with no profiler (no
clock read, no record_function), a call span in both the recorder and
the chrome trace, and each route's build phases on small matrices. The
tests marked `gpu` hold what only the card runs: the three steps of a
launch, and the capture of a solver iteration. This file imports no
JAX, so they run on the card with

    python -m pytest --noconftest -m gpu tests/test_torch_obs.py -q
"""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from tpu_spmv_torch import obs
from tpu_spmv_torch.bench.matrices import laplacian_2d
from tpu_spmv_torch.dist.sharding import ShardedRanked, make_row_mesh
from tpu_spmv_torch.formats.sell import RankedSlabs
from tpu_spmv_torch.kernels.dia import spmv_dia
from tpu_spmv_torch.kernels.packed import spmv_packed
from tpu_spmv_torch.sts.ic0 import IC0Preconditioner
from tpu_spmv_torch.tools.spmv import build_layout, prepare
from tpu_spmv_torch.tune.model import tpu_plan

STEPS = ["entry.check", "entry.alloc", "entry.launch"]
PREFIX = "tpu_spmv_torch."


@pytest.fixture(autouse=True)
def _fresh():
    obs.reset()
    yield
    obs.reset()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _noop(layout, x):
    return x


@obs.entry
def inner(layout, x):
    obs.step("entry.check")


@obs.entry
def outer(layout, x):
    for step in STEPS:
        obs.step(step)
        time.sleep(0.001)
    inner(layout, x)


def _by_name(spans, name):
    return [s for s in spans if s.name == name]


def _outermost_phases(spans):
    """The build phases that no build phase encloses, in order."""
    by = {s.id: s for s in spans}

    def enclosed(s):
        p = s.parent
        while p in by:
            if by[p].name.startswith("build."):
                return True
            p = by[p].parent
        return False

    return [s for s in sorted(spans, key=lambda s: s.start_ns)
            if s.name.startswith("build.") and not enclosed(s)]


def _check_disjoint_and_nested(spans):
    """Outermost phases do not overlap; every span lies inside its
    parent."""
    outer = _outermost_phases(spans)
    for a, b in zip(outer, outer[1:]):
        assert a.end_ns <= b.start_ns, (a, b)
    by = {s.id: s for s in spans}
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent in by:
            p = by[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    return outer


def _trace(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())


def test_nesting_parents_and_self_time():
    with obs.span("build.outer"):
        time.sleep(0.02)
        with obs.span("build.inner"):
            time.sleep(0.03)

    @obs.span("build.decorated")
    def work(v):
        return v + 1

    assert work(1) == 2
    spans = obs.spans()
    outer, = _by_name(spans, "build.outer")
    inner, = _by_name(spans, "build.inner")
    deco, = _by_name(spans, "build.decorated")
    assert outer.parent == 0 and deco.parent == 0
    assert inner.parent == outer.id
    assert outer.start_ns <= inner.start_ns and inner.end_ns <= outer.end_ns
    # Self time: the outer span's duration less what its child covers.
    assert inner.seconds >= 0.03
    assert outer.seconds - inner.seconds >= 0.02
    # Finished spans are kept in the order they closed.
    assert [s.name for s in spans] == [
        "build.inner", "build.outer", "build.decorated"]
    assert obs.phase_seconds() == pytest.approx(
        outer.seconds + deco.seconds)


def test_a_raising_block_still_closes_its_span():
    with pytest.raises(ValueError):
        with obs.span("build.fails"):
            raise ValueError("no")
    with obs.span("build.next"):
        pass
    fails, = _by_name(obs.spans(), "build.fails")
    nxt, = _by_name(obs.spans(), "build.next")
    assert nxt.parent == 0 and fails.parent == 0


def test_the_store_keeps_the_newest_and_counts_the_dropped(monkeypatch):
    rec = obs.Recorder(phase_capacity=4, call_capacity=3)
    monkeypatch.setattr(obs, "RECORDER", rec)
    for i in range(10):
        with obs.span(f"build.s{i}"):
            pass
    held = rec.spans()
    assert [s.name for s in held] == [f"build.s{i}" for i in range(6, 10)]
    assert obs.dropped() == (6, 0)
    # Calls fill a store of their own: past its capacity they drop the
    # oldest calls, never a phase.
    call = obs.entry(_noop)
    monkeypatch.setattr(obs._profiler, "_is_profiler_enabled", True)
    for i in range(5):
        call(None, None)
    monkeypatch.setattr(obs._profiler, "_is_profiler_enabled", False)
    assert [s.name for s in rec.spans()] == (
        [f"build.s{i}" for i in range(6, 10)] + ["entry._noop"] * 3)
    assert obs.dropped() == (6, 2)
    obs.reset()
    assert obs.spans() == [] and obs.dropped() == (0, 0)


def test_phase_seconds_counts_the_phases_after_a_mark():
    with obs.span("build.before"):
        pass
    since = obs.mark()
    with obs.span("build.a"):
        with obs.span("build.a_inner"):
            time.sleep(0.005)
    with obs.span("build.b"):
        pass
    a, = _by_name(obs.spans(), "build.a")
    b, = _by_name(obs.spans(), "build.b")
    assert obs.phase_seconds(since) == pytest.approx(a.seconds + b.seconds)


def test_no_profiler_no_span_no_clock_no_record_function(monkeypatch):
    class Refuse:
        def __getattr__(self, name):
            raise AssertionError(f"time.{name} read with no profiler")

    def no_record_function(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    mat = laplacian_2d(12)
    packed, _, _ = build_layout(mat, "packed", device="cpu")
    dia, _, _ = build_layout(mat, "dia", device="cpu")
    x = torch.randn(mat.n)
    obs.reset()
    monkeypatch.setattr(obs, "time", Refuse())
    monkeypatch.setattr(obs, "_RecordFunction", no_record_function)
    monkeypatch.setattr(torch.profiler, "record_function", no_record_function)
    y = spmv_packed(packed, x)
    assert torch.allclose(y, spmv_dia(dia, x), atol=1e-5)
    for step in STEPS:
        obs.step(step)
    assert obs.spans() == [] and obs.dropped() == (0, 0)


def test_a_call_span_in_the_recorder_and_in_the_chrome_trace(tmp_path):
    mat = laplacian_2d(12)
    lay, fn, kernel = build_layout(mat, "packed", device="cpu")
    assert kernel == "packed"
    x = torch.randn(mat.n)
    obs.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(lay, x)
        # Outside a call span a step records nothing.
        obs.step("entry.check")
    calls = obs.spans()
    assert [s.name for s in calls] == ["entry.spmv_packed"]
    events = [e for e in _trace(prof, tmp_path)["traceEvents"]
              if e.get("name") == "tpu_spmv_torch.entry.spmv_packed"]
    assert len(events) == 1
    assert events[0]["cat"] in ("cpu_op", "user_annotation")
    # After the profiler, calls record nothing again.
    fn(lay, x)
    assert len(obs.spans()) == 1


def test_a_calls_steps_are_stamps_inside_it(tmp_path):
    """Steps are children of the innermost open call, end where the next
    begins (the last where the call ends), and enter no trace: a call is
    one profiler event."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("build.outer"):
            outer(None, None)
    spans = obs.spans()
    build, = _by_name(spans, "build.outer")
    o, = _by_name(spans, "entry.outer")
    i, = _by_name(spans, "entry.inner")
    assert o.parent == build.id and i.parent == o.id
    steps = [s for s in spans if s.parent == o.id and s.name in STEPS]
    assert [s.name for s in steps] == STEPS
    assert steps[0].start_ns >= o.start_ns and steps[-1].end_ns == o.end_ns
    for a, b in zip(steps, steps[1:]):
        assert a.end_ns == b.start_ns
    assert all(s.seconds >= 0.001 for s in steps[:2])
    assert i.start_ns >= steps[-1].start_ns and i.end_ns <= o.end_ns
    ichk, = [s for s in spans if s.parent == i.id]
    assert ichk.name == "entry.check" and ichk.end_ns == i.end_ns
    assert len({s.id for s in spans}) == len(spans)
    _check_disjoint_and_nested(spans)
    names = {e.get("name") for e in _trace(prof, tmp_path)["traceEvents"]}
    assert {"tpu_spmv_torch.build.outer", "tpu_spmv_torch.entry.outer",
            "tpu_spmv_torch.entry.inner"} <= names
    assert not {PREFIX + s for s in STEPS} & names


def test_the_clock_is_the_traces(tmp_path):
    """A span around a record_function block, both converted to
    Unix-epoch us (the trace's ts plus baseTimeNanoseconds / 1000),
    contains the block to within 0.1 ms."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("build.clock"):
            with record_function("clock_block"):
                time.sleep(0.002)
    trace = _trace(prof, tmp_path)
    base_us = int(trace["baseTimeNanoseconds"]) / 1000
    block, = [e for e in trace["traceEvents"]
              if e.get("name") == "clock_block"]
    b0 = float(block["ts"]) + base_us
    b1 = b0 + float(block["dur"])
    span, = _by_name(obs.spans(), "build.clock")
    assert span.start_ns / 1000 <= b0 + 100
    assert span.end_ns / 1000 >= b1 - 100
    assert span.end_ns / 1000 - span.start_ns / 1000 <= (b1 - b0) + 5000
    # The span entered the trace too, under the port's prefix.
    assert [e for e in trace["traceEvents"]
            if e.get("name") == "tpu_spmv_torch.build.clock"]


def test_packed_route_with_rcm_records_its_phases():
    mat = laplacian_2d(24)
    ck, perm = prepare(mat, "always")
    plan = tpu_plan(ck.matrix)
    build_layout(ck.matrix, "packed", val_dtype=None,
                 bin_blocks=plan.bin_blocks, device="cpu")
    outer = _check_disjoint_and_nested(obs.spans())
    assert [s.name for s in outer] == [
        "build.reorder", "build.reorder", "build.reorder", "build.plan",
        "build.layout", "build.to_device"]


def test_dia_route_records_its_phases():
    build_layout(laplacian_2d(24), "dia", device="cpu")
    outer = _check_disjoint_and_nested(obs.spans())
    assert [s.name for s in outer] == ["build.layout", "build.to_device"]


def test_ranked_routes_record_their_phases():
    mat = laplacian_2d(24)
    RankedSlabs.from_csr(mat).to("cpu")
    ShardedRanked.build(mat, 2).device_put(make_row_mesh(["cpu"] * 2))
    spans = obs.spans()
    outer = _check_disjoint_and_nested(spans)
    assert [s.name for s in outer] == [
        "build.layout", "build.to_device", "build.layout", "build.to_device"]
    # The shards' own builds and moves nest in the sharded ones.
    sharded, put = outer[2], outer[3]
    assert len([s for s in spans if s.parent == sharded.id
                and s.name == "build.layout"]) >= 2
    assert len([s for s in spans if s.parent == put.id
                and s.name == "build.to_device"]) == 2


def test_ic0_build_records_factor_schedule_layout_and_move():
    IC0Preconditioner.build(laplacian_2d(16), device="cpu")
    spans = obs.spans()
    outer = _check_disjoint_and_nested(spans)
    assert [s.name for s in outer] == [
        "build.ic0.factor", "build.ic0.schedule", "build.ic0.layout",
        "build.to_device"]
    layout = outer[2]
    inner = {s.name for s in spans if s.parent == layout.id}
    assert inner == {"build.layout", "build.to_device"}


def test_cli_timers_read_the_phase_spans(tmp_path, capsys):
    from tpu_spmv_torch.io.csr_text import write_csr_text
    from tpu_spmv_torch.tools import reformat

    src = tmp_path / "in.csr"
    write_csr_text(src, laplacian_2d(16))
    assert reformat.main([str(src), str(tmp_path / "out.csr3"), "--srs",
                          "8", "--ssrs", "4"]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("preprocessing took")]
    took = float(line[0].split()[-1].rstrip("s"))
    build, = _outermost_phases(obs.spans())
    assert build.name == "build.reorder"
    assert took == pytest.approx(build.seconds, abs=1e-6)


def test_counters_are_set_read_and_reset():
    """The counter store, read as the benchmark reads it: by the module's
    name, never by importing the program."""
    import sys

    obs.set_counters({"dia.route_resident": 0, "dia.x_staged_floats": 512})
    obs.set_counters({"dia.x_staged_floats": 256})
    read = getattr(sys.modules.get("tpu_spmv_torch.obs"), "counters", None)
    assert read() == {"dia.route_resident": 0, "dia.x_staged_floats": 256}
    read()["dia.other"] = 1  # a copy
    assert "dia.other" not in obs.counters()
    obs.reset()
    assert obs.counters() == {}


def _spmm_layouts(mat):
    from tpu_spmv_torch.formats.packed import PackedRanked
    from tpu_spmv_torch.kernels import spmm

    ranked = RankedSlabs.from_csr(mat)
    return {"spmm_packed": (PackedRanked.from_csr(mat), spmm.spmm_packed),
            "spmm_ranked": (ranked, spmm.spmm_ranked),
            "spmm_ranked_windowed": (ranked, spmm.spmm_ranked_windowed)}


@pytest.mark.parametrize("name", ["spmm_packed", "spmm_ranked",
                                  "spmm_ranked_windowed"])
def test_spmm_calls_record_their_span(name):
    mat = laplacian_2d(24)
    lay, fn = _spmm_layouts(mat)[name]
    X = torch.randn(mat.n, 3)
    obs.reset()  # the layouts' build phases
    fn(lay, X)
    assert obs.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            fn(lay, X)
    assert [s.name for s in obs.spans()] == [f"entry.{name}"] * 2


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["spmm_packed", "spmm_ranked",
                                  "spmm_ranked_windowed"])
def test_an_spmm_launch_records_its_three_steps(cuda, name):
    mat = laplacian_2d(64)
    lay, fn = _spmm_layouts(mat)[name]
    lay = lay.to(cuda)
    X = torch.randn(mat.n, 8, device=cuda)
    fn(lay, X)
    torch.cuda.synchronize()
    obs.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        fn(lay, X)
        torch.cuda.synchronize()
    spans = obs.spans()
    call, = _by_name(spans, f"entry.{name}")
    steps = sorted((s for s in spans if s.parent == call.id),
                   key=lambda s: s.start_ns)
    assert [s.name for s in steps] == STEPS


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["packed", "dia"])
def test_a_launch_records_its_three_steps(cuda, kernel):
    mat = laplacian_2d(64)
    lay, fn, got = build_layout(mat, kernel, device=cuda)
    assert got == kernel
    x = torch.randn(mat.n, device=cuda)
    fn(lay, x)
    torch.cuda.synchronize()
    obs.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(3):
            fn(lay, x)
        torch.cuda.synchronize()
    spans = obs.spans()
    calls = _by_name(spans, f"entry.spmv_{kernel}")
    assert len(calls) == 3
    for c in calls:
        steps = sorted((s for s in spans if s.parent == c.id),
                       key=lambda s: s.start_ns)
        assert [s.name for s in steps] == STEPS
        assert c.start_ns <= steps[0].start_ns
        assert steps[-1].end_ns <= c.end_ns
        for a, b in zip(steps, steps[1:]):
            assert a.end_ns <= b.start_ns
    # No profiler, no spans: the launch path runs its steps unrecorded.
    obs.reset()
    fn(lay, x)
    assert obs.spans() == []


@pytest.mark.gpu
def test_capture_records_its_phase_after_the_kernels_load(cuda):
    from tpu_spmv_torch.dist.solvers import capture_step, cg_init
    from tpu_spmv_torch.kernels import _build
    from tpu_spmv_torch.sts.ic0 import capture_pcg_step, pcg_ic0_init

    mat = laplacian_2d(32)
    mesh = make_row_mesh([cuda])
    lay = ShardedRanked.build(mat, 1).device_put(mesh)
    b = torch.ones(lay.padded_m, device=cuda)
    state = cg_init([b], mesh)
    obs.reset()
    capture_step(lay, mesh, state).replay()
    ranked = RankedSlabs.from_csr(mat).to(cuda)
    pre = IC0Preconditioner.build(mat, device=cuda)
    pcg_state = pcg_ic0_init(torch.ones(mat.n, device=cuda), pre)
    capture_pcg_step(ranked, pre, pcg_state).replay()
    torch.cuda.synchronize()
    spans = obs.spans()
    captures = _by_name(spans, "build.capture")
    assert len(captures) == 2 and all(c.parent == 0 for c in captures)
    # The library's load is its own phase, never inside a capture.
    for load in _by_name(spans, "build.kernels"):
        assert load.parent == 0
    assert _build._lib is not None
    _check_disjoint_and_nested(spans)
    assert np.isfinite(float(state[3])) and np.isfinite(float(pcg_state[3]))
