"""The port's flagship bench (python -m tpu_spmv_torch.bench.flagship) on
the CPU: bench.py's sequence at TPU_SPMV_BENCH_N=32, every candidate and
baseline built and validated with the plain versions (Number Wrong 0,
RelL2 <= 1e-6 against the f32 oracle), no time and no JSON line.

The candidates are the ones bench.py's sequence reaches: the planner's
kernel after RCM, the packed and bf16 candidates, and, because both
planners find the natural order's constant diagonals, the DIA and
DIA+bf16 candidates on the natural order.
"""

import pytest
import torch

from tpu_spmv.bench.matrices import laplacian_2d as jax_laplacian_2d
from tpu_spmv.tune.model import tpu_plan

from tpu_spmv_torch.bench import flagship
from tpu_spmv_torch.bench.matrices import laplacian_2d
from tpu_spmv_torch.reorder import rcm
from tpu_spmv_torch.tune.model import tpu_plan as port_tpu_plan

N = 32


def test_flagship_validates_every_candidate_and_baseline(monkeypatch,
                                                         capsys):
    monkeypatch.setenv("TPU_SPMV_BENCH_N", str(N))
    assert flagship.main(["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    assert out == ""  # no JSON line: a CPU time is not the card's
    mat_raw = laplacian_2d(N)
    mat = mat_raw.permuted(rcm(mat_raw.indptr, mat_raw.indices))
    plan = port_tpu_plan(mat, assume_rcm=True).kernel
    for name in (f"{plan}+bf16 candidate", "dia candidate",
                 "dia+bf16 candidate", "baselines: segsum"):
        assert name in err
    assert "GFLOP/s" not in err


def test_flagship_candidates_are_bench_pys():
    mat_raw = laplacian_2d(N)
    mat = mat_raw.permuted(rcm(mat_raw.indptr, mat_raw.indices))
    plan = port_tpu_plan(mat, assume_rcm=True).kernel
    report = flagship.run(N, "cpu")
    names = [name for name, _, _ in report["checked"]]
    after_rcm = [plan] + (["packed"] if plan != "packed" else []) + [
        f"{plan}+bf16"]
    assert names == after_rcm + ["dia", "dia+bf16", "segsum", "bcoo",
                                 "dense"]
    for name, wrong, rel in report["checked"]:
        assert wrong == 0 and rel <= 1e-6, (name, wrong, rel)
    assert report["json"] is None
    # Both planners send the natural order to DIA, as bench.py's sequence
    # needs for its DIA candidates.
    assert port_tpu_plan(mat_raw).kernel == "dia"
    assert tpu_plan(jax_laplacian_2d(N), assume_rcm=False).kernel == "dia"


def test_flagship_needs_a_card_to_time(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        flagship.main([])
