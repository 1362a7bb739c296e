"""Every piece of a cell is found by name, and a new cell or metric is
new files only."""

import json
import pathlib
import re
import shutil

import pytest
import torch

from spmv_bench import run as harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_manifest_resolves():
    bench = harness.manifest()
    assert bench["command"][-1] == "spmv_bench.run"
    four = [w["name"] for w in bench["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(bench["workloads"]) // 4)
    for w in bench["workloads"]:
        files = harness.cell_files(bench, w["name"])
        assert w["chips"] in (1, 4)
        # The CPU tests run every cell at its configuration's small grid.
        assert set(files["config"]["small"]) <= set(files["config"])
        entry = files["traffic"]["entry"]
        assert (harness.HERE / "entries" / f"{entry}.py").exists()
        assert harness.metric_specs(bench, w["name"], False)
        assert harness.metric_specs(bench, w["name"], True)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"])
        assert callable(harness.reader(m["name"]))
    for m in bench["per_layer"]:
        e2e = {e["name"] for e in bench["end_to_end"]}
        assert m["moves"] in e2e
    for path in harness.HERE.rglob("*"):
        if "__pycache__" not in path.parts and "_cache" not in path.parts:
            assert re.match(r"^[A-Za-z0-9_./-]+$",
                            str(path.relative_to(harness.ROOT)))


def _copy(tmp_path: pathlib.Path) -> pathlib.Path:
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "spmv_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", root)
    return root


def test_new_cell_and_metric_are_new_files(tmp_path):
    root = _copy(tmp_path)
    before = {p: p.read_bytes() for p in (root / "spmv_bench").rglob("*")
              if p.is_file()}
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "spmv_bench/configs/ecology1.json").read_text())
    cfg.update(name="grid_24", nx=24, ny=20, c_min=1.0, c_max=2.0)
    (root / "spmv_bench/configs/grid_24.json").write_text(json.dumps(cfg))
    (root / "spmv_bench/traffic/spmv_x2.json").write_text(json.dumps(
        {"entry": "spmv", "inputs": 2, "sample": 4, "trace_seconds": 0.1}))
    (root / "spmv_bench/cells/grid_24.spmv_x2.json").write_text(
        json.dumps({"rel_l2": 1e-5}))
    (root / "spmv_bench/metrics/calls_done.py").write_text(
        "def read(run):\n    return run.counts.get('calls')\n")
    bench["configs"].append({"name": "grid_24", "source": "test",
                             "file": "spmv_bench/configs/grid_24.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "grid_24.spmv_x2", "config": "grid_24",
                               "traffic": "spmv_x2", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "calls_done", "unit": "calls",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["grid_24.spmv_x2"]})
    for m in bench["end_to_end"]:
        if m["name"] == "spmv_gflops.device_bound":
            m["workloads"].append("grid_24.spmv_x2")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    out = harness.run_cell("grid_24.spmv_x2", 5, 0.2, False,
                           torch.device("cpu"), root=root)
    assert out["correct"] and out["attempted"] > 0
    assert out["metrics"]["calls_done"]["value"] == out["attempted"]
    # device_mem_gib reads the card's allocator: nothing on the CPU.
    assert set(out["metrics"]) == {"spmv_gflops.device_bound", "setup_s",
                                   "calls_done"}
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_new_configuration_is_new_files(tmp_path, small):
    """A configuration, with the small grid the CPU tests run it at, and
    a cell of it are files and manifest entries only: the tests that
    run every cell take it as they are."""
    root = _copy(tmp_path)
    before = {p: p.read_bytes() for p in (root / "spmv_bench").rglob("*")
              if p.is_file()}
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "spmv_bench/configs/hpcg_104.json").read_text())
    cfg.update(name="hpcg_48", nx=48, ny=48, nz=48, n=48**3,
               nnz=142**3, small={"nx": 6, "ny": 5, "nz": 7})
    (root / "spmv_bench/configs/hpcg_48.json").write_text(json.dumps(cfg))
    (root / "spmv_bench/cells/hpcg_48.cg.json").write_text(
        json.dumps({"rel_err": 1e-3, "failed_solves": 0}))
    bench["configs"].append({"name": "hpcg_48", "source": "test",
                             "file": "spmv_bench/configs/hpcg_48.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "hpcg_48.cg", "config": "hpcg_48",
                               "traffic": "cg", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "solve_ms.cg":
            m["workloads"].append("hpcg_48.cg")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    out = small("hpcg_48.cg", root=root)
    assert out["correct"] and out["attempted"] > 0
    assert set(out["metrics"]) == {"solve_ms.cg", "setup_s"}
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        harness.cell_files(harness.manifest(), "no_such.cell")


def test_a_class_of_cells_shares_its_quantitys_reader():
    base = harness.reader("spmv_gflops")
    for name in ("spmv_gflops.host_bound", "spmv_gflops.a_new_class",
                 "device_idle.cg.more"):
        read = harness.reader(name)
        assert read.__module__.split(".")[-1] == name.split(".")[0]
    assert harness.reader("spmv_gflops.a_new_class").__code__ == (
        base.__code__)
    assert harness.reader("eager_gflops.host_bound").__code__ == (
        base.__code__)
    with pytest.raises(SystemExit):
        harness.reader("no_such_metric.host_bound")
