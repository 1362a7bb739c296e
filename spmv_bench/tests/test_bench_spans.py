"""The readers of the program's own spans (spmv_bench/spans.py and the
metrics that use it): the outermost-phase rule, the per-call means,
None without the recorder, and discovery of every such metric by name."""

import collections
import sys

import pytest
import torch

from spmv_bench import run as harness
from spmv_bench import spans as rd

S = collections.namedtuple("S", "id parent name start_ns end_ns")

NEW = ["build_plan_s", "build_reorder_s", "build_layout_s",
       "build_to_device_s", "build_kernels_s", "build_capture_s",
       "build_ic0_factor_s", "build_ic0_schedule_s", "build_ic0_layout_s",
       "entry_us.host_bound", "entry_check_us.host_bound",
       "entry_alloc_us.host_bound", "entry_launch_us.host_bound",
       "entry_us.device_bound"]


class FakeRecorder:
    def __init__(self, held):
        self.held = held

    def spans(self):
        return list(self.held)


@pytest.fixture
def recorder(monkeypatch):
    def put(held):
        monkeypatch.setitem(sys.modules, rd.RECORDER, FakeRecorder(held))

    return put


def test_outermost_phase_rule(recorder):
    # layout (1) holds a move (2) and a nested layout (3); a move (4)
    # stands alone; an entry call (5) holds a phase (6), which no build
    # phase encloses.
    recorder([
        S(2, 1, "build.to_device", 10, 20),
        S(3, 1, "build.layout", 20, 40),
        S(1, 0, "build.layout", 0, 100),
        S(4, 0, "build.to_device", 100, 130),
        S(6, 5, "build.kernels", 210, 260),
        S(5, 0, "entry.spmv_packed", 200, 300),
    ])
    assert rd.phase_s("build.layout") == pytest.approx(100e-9)
    assert rd.phase_s("build.to_device") == pytest.approx(30e-9)
    assert rd.phase_s("build.kernels") == pytest.approx(50e-9)
    assert rd.phase_s("build.plan") is None


def test_a_phase_whose_parent_was_dropped_counts(recorder):
    recorder([S(9, 7, "build.ic0.layout", 0, 1000)])
    assert rd.phase_s("build.ic0.layout") == pytest.approx(1e-6)


def test_per_call_means(recorder):
    held = []
    for i, (c, a, l) in enumerate([(3000, 1000, 6000), (5000, 3000, 2000)]):
        base, cid = 100_000 * i, 10 * i + 1
        held += [S(cid + 1, cid, "entry.check", base, base + c),
                 S(cid + 2, cid, "entry.alloc", base + c, base + c + a),
                 S(cid + 3, cid, "entry.launch", base + c + a,
                   base + c + a + l),
                 S(cid, 0, "entry.spmv_packed", base, base + 11000)]
    # A nested call (a stripe's pass) and its steps count in its outer
    # call's launch, not as calls or steps of their own.
    held += [S(51, 4, "entry.spmv_ranked", 9000, 9500),
             S(52, 51, "entry.check", 9000, 9100)]
    recorder(held)
    assert rd.call_us() == pytest.approx(11.0)
    assert rd.step_us("entry.check") == pytest.approx(4.0)
    assert rd.step_us("entry.alloc") == pytest.approx(2.0)
    assert rd.step_us("entry.launch") == pytest.approx(4.0)
    for name, want in (("entry_us.host_bound", 11.0),
                       ("entry_check_us.host_bound", 4.0),
                       ("entry_alloc_us.host_bound", 2.0),
                       ("entry_launch_us.host_bound", 4.0),
                       ("entry_us.device_bound", 11.0)):
        assert harness.reader(name)(None) == pytest.approx(want)


def test_calls_past_the_stores_capacity_leave_the_phases_whole(
        monkeypatch):
    """The program's recorder keeps a traced window's calls apart from
    the build's phases: calls past their store's capacity drop the
    oldest calls, and the phases still read whole. Phases past theirs
    read None, not a partial sum."""
    from tpu_spmv_torch import obs

    rec = obs.Recorder(phase_capacity=4, call_capacity=8)
    monkeypatch.setattr(obs, "RECORDER", rec)
    with obs.span("build.plan"):
        with obs.span("build.layout"):
            pass
    monkeypatch.setattr(obs._profiler, "_is_profiler_enabled", True)
    @obs.entry
    def spmv_packed(layout, x):
        for step in rd.STEPS:
            obs.step(step)

    for _ in range(20):
        spmv_packed(None, None)
    monkeypatch.setattr(obs._profiler, "_is_profiler_enabled", False)
    assert obs.dropped() == (0, 12)
    plan, = [s for s in obs.spans() if s.name == "build.plan"]
    assert rd.phase_s("build.plan") == pytest.approx(plan.seconds)
    assert rd.phase_s("build.layout") is None
    assert len(rd.calls(rd.held())) == 8
    assert rd.call_us() > 0 and rd.step_us("entry.launch") > 0
    for _ in range(3):
        with obs.span("build.layout"):
            pass
    assert obs.dropped().phases == 1
    assert rd.phase_s("build.plan") is None


def test_calls_without_steps_have_no_step_mean(recorder):
    recorder([S(1, 0, "entry.spmv_dia", 0, 2000)])
    assert rd.call_us() == pytest.approx(2.0)
    assert rd.step_us("entry.check") is None


@pytest.mark.parametrize("name", NEW)
def test_every_reader_reads_none_without_the_recorder(monkeypatch, name):
    monkeypatch.delitem(sys.modules, rd.RECORDER, raising=False)
    assert harness.reader(name)(None) is None


@pytest.mark.parametrize("name", NEW)
def test_every_reader_reads_none_from_an_empty_recorder(recorder, name):
    recorder([])
    assert harness.reader(name)(None) is None


@pytest.mark.parametrize("name", NEW)
def test_new_metric_is_found_by_name(name):
    bench = harness.manifest()
    spec, = [m for m in bench["per_layer"] if m["name"] == name]
    assert spec["source"] == "host_clock"
    assert spec["layer"] in ("host build", "entry")
    read = harness.reader(name)
    assert read.__module__.split(".")[-1] == name.split(".")[0]
    for cell in spec.get("workloads", []):
        assert spec in harness.metric_specs(bench, cell, True)


def test_a_traced_cpu_run_reports_the_program_spans(small):
    """On the CPU the port records its build phases and, under the
    traced window's profiler, its entry calls (the plain path: no
    steps, no kernel library)."""
    from tpu_spmv_torch import obs

    obs.reset()
    out = small("ecology1.spmv", trace=True, seconds=0.2)
    obs.reset()
    got = out["metrics"]
    assert out["correct"]
    for name in ("build_plan_s", "build_reorder_s", "build_layout_s",
                 "build_to_device_s", "entry_us.host_bound"):
        assert got[name]["value"] > 0, name
    phases = sum(got[n]["value"] for n in (
        "build_plan_s", "build_reorder_s", "build_layout_s",
        "build_to_device_s"))
    assert phases <= got["host_build_s"]["value"]
    assert "entry_check_us.host_bound" not in got
    assert torch.get_num_threads() == 2
