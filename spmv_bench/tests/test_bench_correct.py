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
SOLVES = ["hpcg_104.cg", "hpcg_104.pcg_ic0"]
STEPS = {"hpcg_104.cg": ("tpu_spmv_torch.dist.solvers", "cg_step"),
         "hpcg_104.pcg_ic0": ("tpu_spmv_torch.sts.ic0", "pcg_ic0_step")}


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


def _break_step(monkeypatch, cell, fault):
    import importlib

    mod_name, fn_name = STEPS[cell]
    mod = importlib.import_module(mod_name)
    step = getattr(mod, fn_name)

    def broken(*args, **kw):
        state = args[-1]
        if fault == "unchanged":
            return state
        x, r, p, rz = step(*args, **kw)
        x0 = x[0] if isinstance(x, list) else x
        x0[x0.numel() // 3] += 1.0
        return x, r, p, rz

    monkeypatch.setattr(mod, fn_name, broken)


@pytest.mark.parametrize("cell", SOLVES)
@pytest.mark.parametrize("fault", ["unchanged", "answer_altered"])
def test_broken_solve_is_not_correct(small, monkeypatch, cell, fault):
    _break_step(monkeypatch, cell, fault)
    out = small(cell, max_iters=40)
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
