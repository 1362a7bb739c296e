"""The port's main path as a whole, on the CPU: the CLI in
--validate-only mode, its y against the JAX pipeline on the same
permuted matrix, the planner's choices, and what the port refuses
(unported options, timing or a device spec without a card, a kernel
call on a device that is neither CPU nor CUDA)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_spmv.bench.matrices import make
from tpu_spmv.formats import dia as jdia
from tpu_spmv.formats import sell as jsell
from tpu_spmv.kernels.dia import spmv_dia as jax_spmv_dia
from tpu_spmv.kernels.pallas_sell import (
    spmv_ranked as jax_spmv_ranked, spmv_sell as jax_spmv_sell,
)

from tpu_spmv_torch import hw
from tpu_spmv_torch.bench.harness import bench_spmv, validate
from tpu_spmv_torch.formats.dia import DiaSlabs
from tpu_spmv_torch.kernels.dia import spmv_dia
from tpu_spmv_torch.tools import spmv as cli
from tpu_spmv_torch.tune.plan import gpu_plan

CPU = ["--device", "cpu", "--validate-only"]


@pytest.mark.parametrize("spec,args,expect", [
    ("lap2d_32", [], "auto kernel: dia"),
    ("lap2d_32", ["--kernel", "dia"], "DIA: 5 diagonals"),
    ("lap2d_32", ["--kernel", "dia", "--val-dtype", "bf16"], "bf16 values"),
    ("lap2d_32", ["--kernel", "ranked"], ""),
    ("lap2d_32", ["--kernel", "sell"], ""),
    ("banded_1k", [], "auto kernel: ranked"),
    ("banded_1k", ["--kernel", "ranked", "--val-dtype", "bf16"], "bf16 values"),
    ("banded_1k", ["--kernel", "sell"], ""),
    ("general_1k", [], "RCM applied"),
    ("general_1k", ["--kernel", "ranked", "--bin-blocks", "4"], "RCM applied"),
    ("general_1k", ["--kernel", "sell"], "RCM applied"),
])
def test_cli_validates(spec, args, expect, capsys):
    rc = cli.main([f"synthetic:{spec}", "3", *args, *CPU])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "Number Wrong: 0 " in out
    assert expect in out


def _jax_y(kernel, matrix, x):
    xj = jnp.asarray(x)
    if kernel == "dia":
        return jax_spmv_dia(jdia.DiaSlabs.from_csr(matrix), xj, interpret=True)
    if kernel == "ranked":
        return jax_spmv_ranked(jsell.RankedSlabs.from_csr(matrix), xj,
                               interpret=True)
    return jax_spmv_sell(jsell.SellSlabs.from_csr(matrix), xj, interpret=True)


@pytest.mark.parametrize("spec,kernel", [
    ("lap2d_32", "dia"), ("banded_1k", "ranked"), ("general_1k", "ranked"),
    ("general_1k", "sell"),
])
def test_slice_matches_jax_pipeline(spec, kernel):
    """The port's reorder + build + kernel against the JAX package's
    layout and Pallas kernel on the same permuted matrix, and both
    against the oracle through the permutation."""
    mat = make(spec)
    ck, perm = cli.prepare(mat, "auto")
    layout, fn, used = cli.build_layout(ck.matrix, kernel)
    assert used == kernel
    x = np.random.default_rng(0).standard_normal(mat.n).astype(np.float32)
    y = fn(layout, torch.from_numpy(x[perm])).numpy()
    y_ref = np.asarray(_jax_y(kernel, ck.matrix, x[perm]))
    for other in (y_ref, mat.matvec(x)[perm]):
        wrong, rel = validate(y, other)
        assert wrong == 0 and rel <= 1e-6


def test_planner_choices():
    lap = make("lap2d_32")
    assert gpu_plan(lap).kernel == "dia" and not gpu_plan(lap).needs_rcm
    assert gpu_plan(make("banded_1k")).kernel == "ranked"
    general = make("general_1k")
    assert gpu_plan(general).kernel == "ranked"
    assert gpu_plan(general).needs_rcm
    assert not gpu_plan(general, assume_rcm=True).needs_rcm


@pytest.mark.parametrize("args,item", [
    (["--kernel", "packed"], "A4"),
    (["--kernel", "striped"], "A10"),
    (["--kernel", "segsum"], "A5"),
    (["--kernel", "bcoo"], "A5"),
    (["--kernel", "dense"], "A5"),
    (["--sigma", "4096"], "A6"),
    (["--layout-cache", "lay.npz"], "A7"),
])
def test_unported_options_are_refused(args, item):
    with pytest.raises(SystemExit) as e:
        cli.main(["synthetic:lap2d_32", *args, *CPU])
    assert f"ROADMAP.md item {item}" in str(e.value)


def test_missing_card_is_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["synthetic:lap2d_32"])
    with pytest.raises(SystemExit, match="timing needs a CUDA card"):
        cli.main(["synthetic:lap2d_32", "--device", "cpu"])
    with pytest.raises(SystemExit, match="ranked/dia"):
        cli.main(["synthetic:lap2d_32", "--kernel", "sell",
                  "--val-dtype", "bf16", *CPU])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hw.device_spec()
    mat = make("lap2d_32")
    with pytest.raises(RuntimeError, match="timing needs a CUDA card"):
        bench_spmv(spmv_dia, DiaSlabs.from_csr(mat), torch.ones(mat.n))


def test_kernel_wrapper_refuses_non_cuda_device():
    mat = make("lap2d_32")
    lay = DiaSlabs.from_csr(mat).to("meta")
    before = spmv_dia.launches
    with pytest.raises(ValueError, match="not a CUDA device"):
        spmv_dia(lay, torch.empty(mat.n, device="meta"))
    assert spmv_dia.launches == before


def test_hbm_bandwidth_table():
    assert hw.hbm_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    with pytest.raises(ValueError):
        hw.hbm_bytes_per_s("some other card")
