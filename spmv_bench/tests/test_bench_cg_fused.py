"""The per-layer metric `cg_fused.<solver>`: listed in the two CG cells
alone, and left out of a CPU run, whose composed step sets no counters
(the reader's own readings are held in tests/test_torch_cg_fused.py)."""

from spmv_bench import run as harness


def test_cg_fused_is_reported_in_the_cg_cells():
    bench = harness.manifest()
    specs = {m["name"]: m for m in bench["per_layer"]
             if m["name"].startswith("cg_fused.")}
    assert set(specs) == {"cg_fused.cg", "cg_fused.cg_x4"}
    for name, cell, moves in (("cg_fused.cg", "hpcg_104.cg", "solve_ms.cg"),
                              ("cg_fused.cg_x4", "hpcg_104x4.cg",
                               "solve_ms.cg_x4")):
        spec = specs[name]
        assert spec["source"] == "program_counter"
        assert spec["layer"] == "kernels" and spec["moves"] == moves
        assert spec["unit"] == "%" and spec["better"] == "higher"
        assert spec in harness.metric_specs(bench, cell, True)
        assert harness.reader(name).__module__.endswith(".cg_fused")
    for cell in ("hpcg_104.pcg_ic0", "hpcg_104.spmv", "ecology1.spmv"):
        assert not set(specs) & {m["name"] for m in
                                 harness.metric_specs(bench, cell, True)}


def test_a_cpu_run_of_the_cg_cell_leaves_it_out(small):
    out = small("hpcg_104.cg", trace=1)
    assert out["correct"]
    assert "cg_fused.cg" not in out["metrics"]
