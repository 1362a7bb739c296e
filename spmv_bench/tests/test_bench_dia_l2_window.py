"""The per-layer metric `dia_l2_window.device_bound`: its reader reads the
DIA route's counters by the recorder's module name, it is listed in the
two DIA cells, and a CPU run of a DIA cell reports it."""

import sys
import types

import pytest

from spmv_bench import run as harness


def test_dia_l2_window_reads_the_route_counters(monkeypatch):
    read = harness.reader("dia_l2_window.device_bound")
    assert read.__module__.split(".")[-1] == "dia_l2_window"
    fake = types.SimpleNamespace(counters=lambda: {
        "dia.route_resident": 1, "dia.l2_window_bytes": 15_263_976,
        "dia.l2_budget_bytes": 26_214_400})
    monkeypatch.setitem(sys.modules, "tpu_spmv_torch.obs", fake)
    assert read(None) == pytest.approx(58.2275, abs=1e-4)
    fake.counters = lambda: {"dia.x_staged_floats": 3004}
    assert read(None) is None
    monkeypatch.setitem(sys.modules, "tpu_spmv_torch.obs",
                        types.SimpleNamespace())
    assert read(None) is None
    monkeypatch.delitem(sys.modules, "tpu_spmv_torch.obs")
    assert read(None) is None


def test_dia_l2_window_is_reported_in_the_dia_cells():
    bench = harness.manifest()
    spec, = [m for m in bench["per_layer"]
             if m["name"] == "dia_l2_window.device_bound"]
    assert spec["source"] == "program_counter" and spec["layer"] == "kernels"
    for cell in ("hpcg_104.spmv", "hpcg_256.spmv"):
        assert spec in harness.metric_specs(bench, cell, True)
    assert spec not in harness.metric_specs(bench, "ecology1.spmv", True)


def test_a_cpu_run_of_a_dia_cell_reports_its_window(small):
    """At the configuration's small grid (12 x 10 x 8) x fits the L2, so
    the route is resident by its x; the window, 2 (12 * 10 + 12 + 1) rows
    of 27 f32 values, y and x, is read from the route's counters."""
    out = small("hpcg_256.spmv", trace=1)
    assert out["correct"]
    window = 2 * (12 * 10 + 12 + 1) * (27 * 4 + 8)
    assert out["metrics"]["dia_l2_window.device_bound"]["value"] == (
        pytest.approx(100 * window / (50 * 2**20 // 2)))
