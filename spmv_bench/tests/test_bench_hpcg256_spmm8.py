"""The cells `hpcg_256.spmv` and `ecology1.spmm8`: the configuration
states NVIDIA's HPCG grid, the SpMM entry counts column products and
judges every column, and the DIA staging reader reads the program's
counter by its module's name."""

import json
import sys
import types

import pytest

from spmv_bench import run as harness
from spmv_bench.entries.spmm import block_work


def _config(name):
    files = {c["name"]: c["file"] for c in harness.manifest()["configs"]}
    with open(harness.ROOT / files[name]) as f:
        return json.load(f)


def test_hpcg_256_states_the_sources_sizes():
    big, one = _config("hpcg_256"), _config("hpcg_104")
    assert (big["nx"], big["ny"], big["nz"]) == (256, 256, 256)
    assert big["n"] == 256 ** 3 == 16_777_216
    assert big["nnz"] == 766 ** 3 == 449_455_096
    assert big["ranks"] == 1 and big["reduced"] == ["ranks"]
    for key in ("generator", "diagonal", "rcm", "precision"):
        assert big[key] == one[key], key
    spec, = [c for c in harness.manifest()["configs"]
             if c["name"] == "hpcg_256"]
    assert spec["reduced"] == big["reduced"]


def test_block_work_counts_a_block_call():
    w = block_work(3, 7, 8)
    assert w.flops == 2 * 7 * 8
    assert w.nbytes == 4 * (7 + 2 * 3 * 8)


def test_new_cells_report_their_class():
    bench = harness.manifest()
    for cell, wanted in (("hpcg_256.spmv", {
            "spmv_gflops.device_bound", "device_mem_gib", "setup_s"}),
            ("ecology1.spmm8", {"device_mem_gib", "setup_s"})):
        got = {m["name"] for m in harness.metric_specs(bench, cell, False)}
        assert wanted <= got, cell
    layer = {m["name"] for m in harness.metric_specs(
        bench, "hpcg_256.spmv", True)}
    assert {"dia_x_staged.device_bound", "spmv_roofline.device_bound",
            "device_idle.device_bound", "issue_us.device_bound",
            "entry_us.device_bound", "build_layout_s"} <= layer


def test_spmm_counts_column_products(small):
    out = small("ecology1.spmm8")
    assert out["correct"]
    assert out["attempted"] > 0 and out["attempted"] % 8 == 0
    assert out["route"]["kernel"].startswith("spmm_")


def _one_column_changed(Y):
    Y = Y.clone()
    Y[Y.shape[0] // 3, 5] += 1.0 + Y[Y.shape[0] // 3, 5].abs()
    return Y


def _last_column_left_out(Y):
    Y = Y.clone()
    Y[:, -1] = 0
    return Y


@pytest.mark.parametrize("alter", [_one_column_changed,
                                   _last_column_left_out])
def test_broken_spmm_is_not_correct(small, monkeypatch, alter):
    import tpu_spmv_torch.tools.spmm as tool

    build = tool.build_spmm

    def broken(*args, **kw):
        layout, fn, passes = build(*args, **kw)
        return layout, lambda lay, X: alter(fn(lay, X)), passes

    monkeypatch.setattr(tool, "build_spmm", broken)
    out = small("ecology1.spmm8")
    assert not out["correct"] and out["failed"] > 0


def test_dia_x_staged_reads_the_counter(monkeypatch):
    read = harness.reader("dia_x_staged.device_bound")
    run = types.SimpleNamespace(config={"n": 1000})
    fake = types.SimpleNamespace(
        counters=lambda: {"dia.x_staged_floats": 3004})
    monkeypatch.setitem(sys.modules, "tpu_spmv_torch.obs", fake)
    assert read(run) == pytest.approx(3.004)
    fake.counters = lambda: {}
    assert read(run) is None
    monkeypatch.setitem(sys.modules, "tpu_spmv_torch.obs",
                        types.SimpleNamespace())
    assert read(run) is None
    monkeypatch.delitem(sys.modules, "tpu_spmv_torch.obs")
    assert read(run) is None
