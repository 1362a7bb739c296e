"""The port's sharded triangular solve (tpu_spmv_torch.dist.sts) and its
(hosts, rows) mesh in one process (tpu_spmv_torch.dist.multihost)
against the JAX package's, on the CPU.

The JAX side runs on tests/conftest.py's 8 virtual CPU devices, its
Pallas kernels in interpret mode; the port runs its shards on
["cpu"] * D through the kernels' plain versions. The cases are
tests/test_dist_sts.py's. Each holds:
  * the stacked arrays (diagonal and off-diagonal blocks, b_scale,
    inv_diag), the scalars and pad_index equal to the reference's;
  * x within RelL2 <= 1e-5 of the float64 forward substitution
    (lower_solve_reference) and of the JAX x, for the built-in b and for
    a fresh b scaled on the device;
  * padding rows solved to exactly 0, also where a whole shard is
    padding and where the off-diagonal block is empty (shard 0);
  * a layout carried from the JAX package gives the port's own bits;
  * the reference's errors, message for message.
The CLI (tools.sts --devices D) prints the reference's lines.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tpu_spmv.bench.matrices import laplacian_2d, random_banded
from tpu_spmv.dist import sts as jsts
from tpu_spmv.dist.multihost import make_hybrid_mesh as jhybrid

from test_torch_dist import one_thread, run_cli  # noqa: F401 (a fixture)
from tpu_spmv_torch.dist import multihost as tmh
from tpu_spmv_torch.dist import sharding as tsh
from tpu_spmv_torch.dist import sts as tsts
from tpu_spmv_torch.formats.csr import CSRMatrix
from tpu_spmv_torch.sts.host import build_sts, compute_b
from tpu_spmv_torch.sts.solve import lower_solve_reference

_ARRAYS = ("dvals", "dcols", "dsub_b0", "dsub_nb", "dsub_chunk", "ovals",
           "ocols", "osub_b0", "osub_nb", "osub_chunk", "b_scale", "inv_diag")
_STATIC = ("m", "padded_m", "rows_per_shard", "num_chunks_local",
           "d_max_nb", "o_max_nb", "n_devices")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _port(mat) -> CSRMatrix:
    return CSRMatrix(mat.indptr, mat.indices, mat.data, mat.shape)


def assert_same_solve_stack(ours, ref):
    for name in _ARRAYS:
        a, b = np.asarray(getattr(ref, name)), getattr(ours, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name
    for name in _STATIC:
        assert getattr(ours, name) == getattr(ref, name), name


def _both(mat, order, D, b, hybrid=False):
    """(port layout, JAX layout, pad_index, port mesh, JAX mesh, axis)."""
    sys_ = build_sts(_port(mat), order_type=order)
    lay, pad = tsts.ShardedLowerSolve.build(sys_, b, D)
    jlay, jpad = jsts.ShardedLowerSolve.build(sys_, b, D)
    assert np.array_equal(pad, jpad)
    assert_same_solve_stack(lay, jlay)
    if hybrid:
        axis = ("hosts", "rows")
        tm = tmh.make_hybrid_mesh(num_hosts=2, devices=["cpu"] * D)
        jm = jhybrid(num_hosts=2)
    else:
        axis = "rows"
        tm = tsh.make_row_mesh(["cpu"] * D)
        jm = Mesh(np.asarray(jax.devices()[:D]), ("rows",))
    return sys_, lay, jlay, pad, tm, jm, axis


def _solve_both(lay, jlay, tm, jm, axis, b=None):
    """(port x, JAX x) over padded_m rows; b: a fresh padded rhs."""
    import jax.numpy as jnp

    tb = None if b is None else tsh.shard_vector(b, tm)
    xs = tsts.sts_solve_sharded(lay.device_put(tm, axis), tm, axis, b=tb)
    assert len(xs) == lay.n_devices
    assert all(t.shape == (lay.rows_per_shard,) for t in xs)
    jb = None if b is None else jnp.asarray(b)
    xj = jsts.sts_solve_sharded(jlay.device_put(jm, axis), jm, axis, b=jb)
    return tsh.gather_vector(xs), np.asarray(xj)


def _check(sys_, lay, jlay, pad, tm, jm, axis, b):
    x, xj = _solve_both(lay, jlay, tm, jm, axis)
    x_ref = lower_solve_reference(sys_, b)
    assert _rel(x[pad], x_ref) <= 1e-5 and _rel(x, xj) <= 1e-5
    padding = np.ones(lay.padded_m, bool)
    padding[pad] = False
    assert not x[padding].any()
    # A fresh b (unscaled, in padded coordinates) overrides the built one.
    b2 = np.random.default_rng(9).standard_normal(sys_.lower.m).astype(
        np.float32)
    bp = np.zeros(lay.padded_m, np.float32)
    bp[pad] = b2
    x2, xj2 = _solve_both(lay, jlay, tm, jm, axis, bp)
    assert _rel(x2[pad], lower_solve_reference(sys_, b2)) <= 1e-5
    assert _rel(x2, xj2) <= 1e-5
    assert not x2[padding].any()
    return x


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_solve_matches_reference(n_dev):
    mat = random_banded(4000, 30, 6, seed=3)
    b = np.random.default_rng(1).standard_normal(mat.m).astype(np.float32)
    sys_, lay, jlay, pad, tm, jm, axis = _both(mat, "COLOR", n_dev, b)
    assert lay.rows_per_shard * (n_dev - 1) < lay.padded_m
    _check(sys_, lay, jlay, pad, tm, jm, axis, b)


def test_sharded_solve_hybrid_mesh():
    """Over the (hosts, rows) mesh, shards hosts-major on the tuple axis."""
    mat = laplacian_2d(90)  # 8100 rows
    sys_ = build_sts(_port(mat), order_type="COLOR")
    b = compute_b(sys_.lower)  # x_exact = ones
    sys_, lay, jlay, pad, tm, jm, axis = _both(mat, "COLOR", 8, b,
                                               hybrid=True)
    assert tm.shape == (2, 4)
    x = _check(sys_, lay, jlay, pad, tm, jm, axis, b)
    assert _rel(x[pad], np.ones(mat.m)) <= 1e-5


def test_sharded_solve_many_packs_ls():
    """LS on a banded system: many 128-padded packs, shard boundaries in
    the middle of the pack sequence, and shards mostly padding."""
    mat = random_banded(900, 25, 5, seed=7)
    b = np.random.default_rng(8).standard_normal(mat.m).astype(np.float32)
    sys_, lay, jlay, pad, tm, jm, axis = _both(mat, "LS", 4, b)
    # Shard 0's off-diagonal block is empty; every shard is mostly
    # padding (900 rows in 16,384).
    assert not lay.ovals[0].any()
    real = np.bincount(pad // lay.rows_per_shard, minlength=4)
    assert real.max() < lay.rows_per_shard // 4, real
    _check(sys_, lay, jlay, pad, tm, jm, axis, b)


def test_shard_containers_end_at_the_real_subtiles():
    """Each shard's containers: the diagonal block with its wait table,
    the off-diagonal one over global columns (n = padded_m), both
    leaving the stacks' padding sub-tiles out of their tables."""
    mat = random_banded(900, 25, 5, seed=7)
    sys_ = build_sts(_port(mat), order_type="LS")
    lay, _ = tsts.ShardedLowerSolve.build(sys_, compute_b(sys_.lower), 4)
    nc = lay.num_chunks_local
    for d in range(4):
        diag, off = lay.diag[d], lay.off[d]
        assert diag.wait_ptr is not None and off.n == lay.padded_m
        for s, chunk in ((diag, lay.dsub_chunk[d]), (off, lay.osub_chunk[d])):
            real = int((chunk < nc).sum())
            assert int(s.chunk_ptr[-1]) == real == int(s.seg_ptr[-1])
        assert lay.steps[d][0, 0] == 0 and lay.steps[d][-1, 0] == nc


def test_layout_from_reference_gives_the_same_bits():
    mat = random_banded(900, 25, 5, seed=7)
    sys_ = build_sts(_port(mat), order_type="LS")
    b = compute_b(sys_.lower)
    lay, _ = tsts.ShardedLowerSolve.build(sys_, b, 4)
    jlay, _ = jsts.ShardedLowerSolve.build(sys_, b, 4)
    from tpu_spmv_torch.formats.convert import from_reference

    tm = tsh.make_row_mesh(["cpu"] * 4)
    x = tsh.gather_vector(tsts.sts_solve_sharded(lay.device_put(tm), tm))
    for carried in (from_reference(jlay), tsts.from_reference(jlay, sys_)):
        assert_same_solve_stack(carried, jlay)
        xc = tsh.gather_vector(tsts.sts_solve_sharded(carried.device_put(tm),
                                                      tm))
        assert np.array_equal(xc, x)


def test_mesh_errors_are_the_references():
    mat = laplacian_2d(40)
    sys_ = build_sts(_port(mat), order_type="COLOR")
    lay, _ = tsts.ShardedLowerSolve.build(sys_, compute_b(sys_.lower), 8)
    mesh = tmh.make_hybrid_mesh(num_hosts=2, devices=["cpu"] * 8)
    placed = lay.device_put(mesh, ("hosts", "rows"))
    with pytest.raises(ValueError, match="layout was built for 8 shards but "
                       "axis 'rows' spans 4 devices"):
        tsts.sts_solve_sharded(placed, mesh, "rows")
    with pytest.raises(KeyError, match="no axis 'cols'"):
        tsts.sts_solve_sharded(placed, mesh, ("hosts", "cols"))
    with pytest.raises(ValueError, match="b must be 8 shards"):
        tsts.sts_solve_sharded(placed, mesh, ("hosts", "rows"),
                               b=[torch.zeros(3)] * 8)


def test_hybrid_mesh_matches_the_references():
    mesh = tmh.make_hybrid_mesh(num_hosts=2, devices=["cpu"] * 8)
    jm = jhybrid(num_hosts=2)
    assert mesh.shape == jm.devices.shape == (2, 4)
    assert mesh.axis_names == jm.axis_names == tmh.row_spec()
    assert tsh.mesh_axis_size(mesh, tmh.row_spec()) == 8
    assert tsh.mesh_axis_size(mesh, "hosts") == 2
    one = tmh.make_hybrid_mesh(devices=["cpu"] * 3)  # one host by default
    assert one.shape == (1, 3) and one.size == 3
    odd = tmh.make_hybrid_mesh(num_hosts=2, devices=["cpu"] * 7)
    assert odd.shape == (2, 3) and odd.size == 6


def test_initialize_is_single_process(monkeypatch):
    for var in ("TPU_SPMV_NUM_PROCESSES", "TPU_SPMV_COORDINATOR",
                "TPU_SPMV_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert tmh.initialize() is False
    assert tmh.initialize(num_processes=1) is False
    monkeypatch.setenv("TPU_SPMV_NUM_PROCESSES", "1")
    assert tmh.initialize() is False


@pytest.mark.parametrize("how", ["args", "env"])
def test_initialize_needs_the_process_count(how, monkeypatch):
    """A coordinator without a process count raises, naming the variable:
    torch cannot detect the count, as jax.distributed can on a TPU pod
    (the two-process runs are tests/test_torch_multiprocess.py)."""
    for var in ("TPU_SPMV_NUM_PROCESSES", "TPU_SPMV_COORDINATOR",
                "TPU_SPMV_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    if how == "env":
        monkeypatch.setenv("TPU_SPMV_COORDINATOR", "localhost:12355")
        monkeypatch.setenv("TPU_SPMV_PROCESS_ID", "0")
        call = tmh.initialize
    else:
        def call():
            return tmh.initialize("localhost:12355", process_id=1)
    with pytest.raises(ValueError, match="TPU_SPMV_NUM_PROCESSES"):
        call()
    assert tmh.process_count() == 1 and tmh.backend() is None


def test_dist_exports_the_solve():
    import tpu_spmv.dist as jdist
    import tpu_spmv_torch.dist as tdist

    for name in ("ShardedLowerSolve", "sts_solve_sharded"):
        assert hasattr(jdist, name) and hasattr(tdist, name), name
    assert tdist.sts_solve_sharded is tsts.sts_solve_sharded


@pytest.mark.parametrize("argv", [
    ["synthetic:banded_1k", "--devices", "2"],
    ["synthetic:banded_1k", "--devices", "4", "--validate-only"],
    ["synthetic:banded_1k", "--devices", "2", "--order", "COLOR"],
    ["synthetic:lap2d_32", "--devices", "3", "--part", "upper"],
])
def test_sts_cli_devices_as_the_reference(argv):
    """tools.sts --devices D (D shards on the CPU) beside the JAX CLI on
    the virtual devices: the same lines, Total Error within f32 rounding
    of the reference's."""
    from tpu_spmv.tools import sts as jcli
    from tpu_spmv_torch.tools import sts as tcli

    rc_j, out_j = run_cli(jcli.main, argv)
    rc_t, out_t = run_cli(tcli.main, [*argv, "--device", "cpu"])
    assert rc_t == rc_j == 0, (out_t, out_j)

    def lines(out):
        return [ln for ln in out.splitlines() if not ln.startswith(
            "Total Error")]

    assert lines(out_t) == lines(out_j)
    assert "Number Wrong: 0" in out_t and "devices=" in out_t

    def total(out):
        return abs(float(out.split("Total Error: ")[1].split()[0]))

    assert total(out_t) <= 1e-4 and total(out_j) <= 1e-4
