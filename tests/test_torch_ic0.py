"""The port's IC(0)-PCG against the JAX package's.

ic0_factor is the same native routine (or the same NumPy twin), so the
factors are bit-equal. IC0Preconditioner.apply (two plain solves on the
CPU) is held against JAX's apply in Pallas interpret mode and against
scipy's two triangular solves in f64, RelL2 <= 1e-6 as
tests/test_ic0.py holds the reference. pcg_ic0_solve follows JAX's loop
to RelL2 <= 1e-4 in x after 10 iterations (both in f32; the two
packages' solves round differently, and CG amplifies the difference).
The solve CLI runs on the CPU as the JAX CLI runs (plain CG, Jacobi,
IC(0), ic0-bj on one device, and both distributed preconditioners on
D > 1 shards).

The distributed preconditioners (tests/test_ic0.py's cases), the JAX
side on tests/conftest.py's virtual devices in interpret mode, the port
on ["cpu"] * D: arrays and index maps equal to the reference's; z of
one application within RelL2 <= 1e-5 of the JAX z (the block-Jacobi z
also within 1e-6 of blockwise scipy solves in f64, the reference's own
bar); PCG x within RelL2 <= 1e-4 of the JAX x after the same 25
iterations, with the reference's residual bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.linalg import spsolve_triangular

from tpu_spmv.bench.matrices import laplacian_2d, random_banded
from tpu_spmv.formats import sell as jsell
from tpu_spmv.reorder.rcm import rcm
from tpu_spmv.sts import ic0 as jic0

from test_torch_dist import one_thread  # noqa: F401 (a fixture)
from test_torch_sts import _assert_same_solve_layout
from tpu_spmv_torch.formats.sell import RankedSlabs
from tpu_spmv_torch.sts import host as thost
from tpu_spmv_torch.sts import ic0 as tic0


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("dominant", [True, False])
def test_ic0_factor_bit_equal(dominant):
    mat = random_banded(300, 20, 6, seed=1, diagonally_dominant=dominant)
    L, bad = tic0.ic0_factor(mat)
    Lj, badj = jic0.ic0_factor(mat)
    assert bad == badj and (bad == 0) == dominant
    assert np.array_equal(L.indptr, Lj.indptr)
    assert np.array_equal(L.indices, Lj.indices)
    assert np.array_equal(np.asarray(L.data).view(np.uint32),
                          np.asarray(Lj.data).view(np.uint32))
    lower, _ = thost.split_lu(mat)
    vals, bad_np = tic0._ic0_numpy(lower.indptr, lower.indices, lower.data)
    assert bad_np == bad
    assert np.array_equal(vals.view(np.uint32),
                          np.asarray(L.data).view(np.uint32))


def test_ic0_systems_match_reference():
    mat = random_banded(400, 25, 6, seed=4)
    port = tic0._build_ic0_systems(mat)
    ref = jic0._build_ic0_systems(mat)
    for i in (2, 5):  # sys_l, sys_u
        assert np.array_equal(port[i].perm, ref[i].perm)
        assert np.array_equal(port[i].pack_ptr, ref[i].pack_ptr)
    for i in (3, 4, 6):  # inv_l, rev, inv_u
        assert np.array_equal(port[i], ref[i])


def test_ic0_systems_keep_their_raises(monkeypatch):
    """A schedule that leaks nnz into the upper split is refused."""
    real = tic0.build_sts

    def leaky(mat, **kw):
        return real(mat, order_type="LS", sort_packs=True)

    mat = random_banded(300, 30, 6, seed=2)
    monkeypatch.setattr(tic0, "build_sts", leaky)
    with pytest.raises(ValueError, match="failed to preserve"):
        tic0._build_ic0_systems(mat)


def test_ic0_apply_matches_pallas_and_scipy():
    mat = random_banded(700, 30, 8, seed=5)
    pre = tic0.IC0Preconditioner.build(mat, device="cpu")
    jpre = jic0.IC0Preconditioner.build(mat)
    assert pre.breakdowns == jpre.breakdowns == 0
    _assert_same_solve_layout(jpre.lay_l, pre.lay_l)
    _assert_same_solve_layout(jpre.lay_u, pre.lay_u)
    for mine, theirs in ((pre.idx0, jpre.idx0), (pre.idx1, jpre.idx1),
                         (pre.idx2, jpre.idx2)):
        assert np.array_equal(mine.numpy(), np.asarray(theirs))

    r = np.random.default_rng(0).standard_normal(mat.m).astype(np.float32)
    z = pre.apply(torch.from_numpy(r)).numpy()
    z_jax = np.asarray(jpre.apply(jnp.asarray(r), interpret=True))
    L, _ = tic0.ic0_factor(mat)
    Ls = L.to_scipy().astype(np.float64).tocsr()
    y = spsolve_triangular(Ls, r.astype(np.float64), lower=True)
    z_ref = spsolve_triangular(sp.csr_matrix(Ls.T), y, lower=False)
    assert _rel(z, z_ref) <= 1e-6
    assert _rel(z, z_jax) <= 1e-6


def test_pcg_matches_jax_loop():
    mat = laplacian_2d(12)
    mat = mat.permuted(rcm(mat.indptr, mat.indices))
    b = np.random.default_rng(3).standard_normal(mat.m).astype(np.float32)
    pre = tic0.IC0Preconditioner.build(mat, device="cpu")
    x, rz = tic0.pcg_ic0_solve(RankedSlabs.from_csr(mat),
                               torch.from_numpy(b), pre, iters=10)
    xj, rzj = jic0.pcg_ic0_solve(
        jsell.RankedSlabs.from_csr(mat), jnp.asarray(b),
        jic0.IC0Preconditioner.build(mat), iters=10, interpret=True,
    )
    assert _rel(x.numpy(), np.asarray(xj)) <= 1e-4
    assert np.isfinite(float(rz)) and float(rz) >= 0
    resid = np.linalg.norm(mat.matvec(x.numpy()) - b) / np.linalg.norm(b)
    assert resid < 1e-4


def test_pcg_step_state_and_guards():
    """pcg_ic0_step takes and returns (x, r, p, rz) as tensors, and once
    the residual is exactly zero the guards keep every value finite."""
    mat = laplacian_2d(10)
    pre = tic0.IC0Preconditioner.build(mat, device="cpu")
    lay = RankedSlabs.from_csr(mat)
    state = tic0.pcg_ic0_init(torch.zeros(mat.m), pre)
    assert float(state[3]) == 0.0
    for _ in range(2):
        state = tic0.pcg_ic0_step(lay, pre, state)
    assert all(torch.isfinite(t).all() for t in state)
    assert state[3].dim() == 0 and not state[0].any()


def test_solve_cli_on_cpu(capsys):
    from tpu_spmv_torch.tools import solve

    rc = solve.main(["synthetic:banded_1k", "--iters", "25", "--precond",
                     "ic0", "--devices", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "ic0: rows=1000 breakdowns=0" in out
    assert "iters=25 rms_residual=" in out
    # Too few iterations miss --tol and exit 1, as the JAX CLI does.
    assert solve.main(["synthetic:lap2d_32", "--iters", "2", "--precond",
                       "ic0", "--device", "cpu"]) == 1


@pytest.mark.parametrize("args", [
    [],
    ["--pcg", "--precond", "ic0"],
    ["--precond", "jacobi"],
    ["--precond", "ic0-bj"],
    ["--precond", "ic0", "--overlap"],
])
def test_solve_cli_runs_as_the_reference(args, one_thread):
    """What the port once refused runs on the CPU: plain CG and Jacobi
    over one shard, IC(0) with --pcg or --overlap ignored as the JAX CLI
    ignores them, and ic0-bj on one device as exact IC(0); the residual
    line agrees with tpu_spmv.tools.solve's at the same --devices."""
    from test_torch_dist import assert_solve_cli_agrees

    argv = ["synthetic:banded_1k", *args, "--devices", "1"]
    assert_solve_cli_agrees(argv)
    assert_solve_cli_agrees(argv, iters=60)


@pytest.mark.parametrize("args", [
    ["--precond", "ic0", "--devices", "2"],
    ["--precond", "ic0-bj", "--devices", "2"],
])
def test_solve_cli_distributed_ic0(args, one_thread):
    """The distributed preconditioners through the CLI, D shards on the
    CPU beside the JAX CLI on the virtual devices: the same route lines
    and residuals (tests/test_ic0.py:235, :251 at D = 4 below)."""
    from test_torch_dist import assert_solve_cli_agrees

    kind = "distributed" if "ic0" in args else "block-Jacobi"
    out = assert_solve_cli_agrees(["synthetic:banded_1k", *args])
    assert f"({kind}, D=2): rows=1000 breakdowns=0" in out


# The distributed preconditioners: tests/test_ic0.py's matrices and D.

def _meshes(D):
    import jax

    from tpu_spmv.dist.sharding import make_row_mesh as jmesh
    from tpu_spmv_torch.dist.sharding import make_row_mesh

    return jmesh(jax.devices()[:D]), make_row_mesh(["cpu"] * D)


def _jshard(v, mesh):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.device_put(jnp.asarray(v), NamedSharding(mesh, P("rows")))


def _sharded_case(mat, D, kind):
    """(port precond placed, JAX precond placed, port and JAX ShardedRanked
    placed, meshes), the arrays and maps held equal to the reference's."""
    from tpu_spmv.dist import sharding as jsh
    from tpu_spmv_torch.dist import sharding as tsh
    from test_torch_dist_sts import assert_same_solve_stack

    jm, tm = _meshes(D)
    jl = jsh.ShardedRanked.build(mat, D)
    tl = tsh.ShardedRanked.build(mat, D)
    jp = getattr(jic0, kind).build(mat, D, jl.padded_m)
    tp = getattr(tic0, kind).build(mat, D, tl.padded_m)
    assert tp.breakdowns == jp.breakdowns == 0
    if kind == "ShardedIC0Preconditioner":
        assert_same_solve_stack(tp.lay_l, jp.lay_l)
        assert_same_solve_stack(tp.lay_u, jp.lay_u)
        names = ("bl_gather", "bl_scatter", "bu_gather", "bu_scatter",
                 "z_gather")
        static = ("m", "padded_m_a")
    else:
        names = ("lvals", "lcols", "lsub_b0", "lsub_nb", "lsub_chunk",
                 "uvals", "ucols", "usub_b0", "usub_nb", "usub_chunk",
                 "g_l", "inv_l", "g_u", "inv_u", "g_z")
        static = ("m", "padded_m_a", "rows_per_shard", "nc_l", "nc_u",
                  "l_max_nb", "u_max_nb", "n_devices")
    for name in names:
        a, b = np.asarray(getattr(jp, name)), getattr(tp, name).numpy()
        assert a.shape == b.shape and np.array_equal(a, b), name
    for name in static:
        assert getattr(tp, name) == getattr(jp, name), name
    return (tp.device_put(tm), jp.device_put(jm), tl.device_put(tm),
            jl.device_put(jm), tm, jm)


def _apply_both(tp, jp, tm, jm, r):
    from tpu_spmv_torch.dist import sharding as tsh

    z = tsh.gather_vector(tp.apply(tsh.shard_vector(r, tm), tm))
    zj = np.asarray(jp.apply(_jshard(r, jm), jm, interpret=True))
    return z, zj


def _pcg_both(tp, jp, tl, jl, tm, jm, mat, iters=25):
    from tpu_spmv_torch.dist import sharding as tsh

    bp = np.zeros(tl.padded_m, np.float32)
    bp[: mat.m] = 1.0
    x, rz = tic0.pcg_ic0_sharded(tl, tsh.shard_vector(bp, tm), tp, tm,
                                 iters=iters)
    xj, _ = jic0.pcg_ic0_sharded(jl, _jshard(bp, jm), jp, jm, iters=iters)
    assert rz.dim() == 0 and np.isfinite(float(rz))
    x = tsh.gather_vector(x)
    assert not x[mat.m:].any()
    return x[: mat.m], np.asarray(xj)[: mat.m]


@pytest.mark.parametrize("kind", ["ShardedIC0Preconditioner",
                                  "BlockJacobiIC0Preconditioner"])
def test_pcg_ic0_sharded_matches_jax(kind, one_thread):
    """Exact distributed IC(0) (two chains an application) and
    block-Jacobi IC(0) at D = 4 on the RCM-ordered banded system: z of
    one application, then PCG's x after 25 iterations, against JAX's."""
    mat = random_banded(3000, 50, 8, seed=2)
    mat = mat.permuted(rcm(mat.indptr, mat.indices))
    tp, jp, tl, jl, tm, jm = _sharded_case(mat, 4, kind)
    r = np.zeros(tl.padded_m, np.float32)
    r[: mat.m] = np.random.default_rng(0).standard_normal(mat.m)
    z, zj = _apply_both(tp, jp, tm, jm, r)
    assert _rel(z, zj) <= 1e-5 and not z[mat.m:].any()
    if kind == "ShardedIC0Preconditioner":
        # Exact IC(0): the single-device preconditioner's z.
        one = tic0.IC0Preconditioner.build(mat, device="cpu")
        assert _rel(z[: mat.m], one.apply(torch.from_numpy(
            r[: mat.m])).numpy()) <= 1e-5
    x, xj = _pcg_both(tp, jp, tl, jl, tm, jm, mat)
    assert _rel(x, xj) <= 1e-4
    assert np.linalg.norm(mat.matvec(x) - 1.0) / np.sqrt(mat.m) < 1e-5


def _block_jacobi_oracle(mat, D, rows_per_shard, r):
    """Blockwise (L_d L_d^T)^-1 r by scipy's triangular solves in f64."""
    z = np.zeros_like(r, dtype=np.float64)
    sp_mat = mat.to_scipy().tocsr()
    for d in range(D):
        r0 = min(d * rows_per_shard, mat.m)
        r1 = min((d + 1) * rows_per_shard, mat.m)
        if r1 == r0:
            continue
        from tpu_spmv_torch.formats.csr import CSRMatrix

        L, bad = tic0.ic0_factor(CSRMatrix.from_scipy(
            sp_mat[r0:r1, r0:r1].tocsr()))
        assert bad == 0
        Ls = L.to_scipy().astype(np.float64).tocsr()
        rb = r[d * rows_per_shard : d * rows_per_shard + (r1 - r0)]
        y = spsolve_triangular(Ls, rb.astype(np.float64), lower=True)
        z[d * rows_per_shard : d * rows_per_shard + (r1 - r0)] = (
            spsolve_triangular(sp.csr_matrix(Ls.T), y, lower=False))
    return z


def test_block_jacobi_ic0_apply_matches_blockwise_scipy(one_thread):
    """D = 8 over 3,000 rows: a partly filled last real shard and five
    all-padding shards (the 1x1 identity), z equal to blockwise solves
    and to JAX's, padding rows exactly zero."""
    mat = random_banded(3000, 50, 8, seed=7)
    tp, jp, tl, jl, tm, jm = _sharded_case(
        mat, 8, "BlockJacobiIC0Preconditioner")
    r = np.zeros(tl.padded_m, np.float32)
    r[: mat.m] = np.random.default_rng(0).standard_normal(mat.m)
    z, zj = _apply_both(tp, jp, tm, jm, r)
    z_ref = _block_jacobi_oracle(mat, 8, tp.rows_per_shard, r)
    assert _rel(z, z_ref) < 1e-6 and _rel(z, zj) <= 1e-5
    assert not z[mat.m:].any()


def test_sharded_preconditioners_from_reference(one_thread):
    """Carried from the JAX package (chunk-by-chunk plain steps), both
    give the port's own z."""
    mat = random_banded(1500, 40, 8, seed=4)
    from tpu_spmv_torch.dist import sharding as tsh

    _, tm = _meshes(2)
    r = np.zeros(2048, np.float32)
    r[: mat.m] = np.random.default_rng(1).standard_normal(mat.m)
    for kind in ("ShardedIC0Preconditioner", "BlockJacobiIC0Preconditioner"):
        ours = getattr(tic0, kind).build(mat, 2, 2048).device_put(tm)
        carried = tic0.from_reference(getattr(jic0, kind).build(
            mat, 2, 2048)).device_put(tm)
        z1, z2 = (tsh.gather_vector(p.apply(tsh.shard_vector(r, tm), tm))
                  for p in (ours, carried))
        assert np.array_equal(z1, z2), kind
    with pytest.raises(ValueError, match="preconditioner built for 2 "
                       "devices, mesh axis 'rows' spans 4 devices"):
        ours.apply(tsh.shard_vector(np.zeros(4096, np.float32),
                                    _meshes(4)[1]), _meshes(4)[1])


def test_solve_cli_needs_a_card(monkeypatch):
    from tpu_spmv_torch.tools import solve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        solve.main(["synthetic:banded_1k", "--precond", "ic0"])
