"""What decides `correct`: sound runs pass, the bfloat16 control, run
in the program's place, comes out not correct, and so does a run whose
timed path is broken underneath. On the CPU at small grids with the
port's plain versions: the harness's look for a card is skipped, and
the rest of a run is driven as on the card."""

import pytest
import torch

from spmv_bench import run as harness

CELLS = [w["name"] for w in harness.manifest()["workloads"]]
SPMV = [c for c in CELLS if c.endswith(".spmv")]
# The solve cells, by their mixes' solver: what a fault is planted in.
PRECOND = {c: harness.cell_files(harness.manifest(), c)["traffic"].get(
    "precond") for c in CELLS}
SOLVES = [c for c in CELLS if PRECOND[c] is not None]


def _limits(cell):
    return harness.cell_files(harness.manifest(), cell)["limits"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(small, cell):
    out = small(cell, trace=True)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [1, 2**31 + 5, 2**33 + 1])
def test_control_fails_the_limit(small, cell, seed):
    out = small(cell, seed=seed, control=True)
    assert not out["correct"] and out["failed"] > 0, out["checks"]
    assert out["route"].get("kernel", out["route"].get("order")) == (
        "control_bf16")
    assert any(c["value"] is None or c["value"] > c["limit"]
               for c in out["checks"].values()), out["checks"]


def _break_spmv(monkeypatch, alter):
    import tpu_spmv_torch.tools.spmv as tool

    build = tool.build_layout

    def broken(*args, **kw):
        layout, fn, kernel = build(*args, **kw)
        return layout, lambda lay, x: alter(fn(lay, x)), kernel

    monkeypatch.setattr(tool, "build_layout", broken)


def _one_changed(y):
    y = y.clone()
    y[y.numel() // 3] += 1.0 + y[y.numel() // 3].abs()
    return y


def _half_left_out(y):
    y = y.clone()
    y[y.numel() // 2:] = 0
    return y


@pytest.mark.parametrize("cell", SPMV)
@pytest.mark.parametrize("alter", [_one_changed, _half_left_out])
def test_broken_spmv_is_not_correct(small, monkeypatch, cell, alter):
    _break_spmv(monkeypatch, alter)
    out = small(cell)
    assert not out["correct"] and out["failed"] > 0


@pytest.mark.parametrize("cell", SOLVES)
@pytest.mark.parametrize("fault", ["unchanged", "answer_altered"])
def test_broken_solve_is_not_correct(small, cell, fault):
    out = small(cell, max_iters=40, fault=("step", PRECOND[cell], fault))
    assert not out["correct"] and out["failed"] > 0
    if fault == "unchanged":
        assert out["checks"]["failed_solves"]["value"] > 0
    else:
        assert out["checks"]["rel_err"]["value"] > _limits(cell)["rel_err"]


def test_solve_check_draws_from_the_seed():
    from spmv_bench.entries.solve import extra_rhs
    from spmv_bench.matrices import generate

    cfg = dict(harness.cell_files(harness.manifest(), "hpcg_104.cg")["config"],
               nx=5, ny=4, nz=3)
    csr = generate(cfg, 0)
    a, b = (extra_rhs(csr, 2, seed, "cpu") for seed in (7, 2**33 + 7))
    assert a.shape == (2, csr.n) and not torch.equal(a, b)
    assert torch.equal(a, extra_rhs(csr, 2, 7, "cpu"))


def test_reference_solves_many_as_it_solves_one():
    from spmv_bench.matrices import generate
    from spmv_bench.reference import cg

    cfg = dict(harness.cell_files(harness.manifest(), "hpcg_104.cg")["config"],
               nx=7, ny=6, nz=9)
    csr = generate(cfg, 0)
    bs = torch.rand(3, csr.n, generator=torch.Generator().manual_seed(5),
                    dtype=torch.float64) + 0.5
    many = cg.solve_many(csr, bs)
    one = torch.stack([cg.solve(csr, b) for b in bs])
    assert many.shape == bs.shape
    assert float((many - one).abs().max() / one.abs().max()) < 1e-10
