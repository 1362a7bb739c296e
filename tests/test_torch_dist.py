"""The port's distributed layer (tpu_spmv_torch.dist) against the JAX
package's (tpu_spmv.dist) on the CPU.

The JAX side runs on tests/conftest.py's 8 virtual CPU devices, its
Pallas kernels in interpret mode; the port runs its shards on
["cpu"] * D, through the kernels' plain versions. Both get the same
seeded numpy inputs, on tests/test_dist.py's matrices and shard counts
(the cases of the single-axis mesh, and the four of the (hosts, rows)
mesh of tpu_spmv_torch.dist.multihost over the tuple axis).

Each case holds:
  * the port's stacked arrays equal to the reference's, array for array
    (ShardedSell, ShardedRanked with and without the shared group plan,
    column-binned, at the uniform tile, and both stacks of OverlapRanked);
  * SpMV/SpMM: Number Wrong 0 at the magnitude-aware 0.01 and RelL2 <=
    1e-6, against the serial oracle and against the JAX result;
  * CG and Jacobi-PCG: the residual the reference's test asks for, and x
    within RelL2 <= 1e-4 of the JAX x after the same iterations (both in
    f32; the dot products sum in another order, which CG amplifies; plain
    CG on the ill-scaled system of the PCG case is held to 1e-2);
  * the reference's errors, message for message.

The CLIs (tools.solve, tools.spmm) run with an explicit --devices beside
the JAX package's, their `devices=... halo=...` lines equal and their
residuals or Number Wrong in agreement.
"""

import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tpu_spmv.bench.matrices import laplacian_2d, random_banded, random_general
from tpu_spmv.dist import sharding as jsh
from tpu_spmv.dist import solvers as jsolvers
from tpu_spmv.formats.csr import CSRMatrix as JCSR

from tpu_spmv_torch.bench.harness import validate
from tpu_spmv_torch.dist import sharding as tsh
from tpu_spmv_torch.dist import solvers as tsolvers
from tpu_spmv_torch.formats.csr import CSRMatrix

_RANKED = ("vals", "lcols", "sub_b0", "sub_dlo", "sub_dhi", "sub_chunk",
           "tile_b0", "grp_b0")
_RANKED_STATIC = ("m", "n", "nnz", "rows_per_shard", "num_chunks_local",
                  "rank_nb", "n_devices", "halo", "chunk_q", "win_w",
                  "tile_k", "group_code", "local_n")
_SELL = ("vals", "cols", "sub_b0", "sub_nb", "sub_chunk")
_SELL_STATIC = ("m", "n", "nnz", "rows_per_shard", "num_chunks_local",
                "max_nb", "n_devices", "halo", "chunk_q")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread for the module. The kernels' plain versions are
    parallel regions on the CPU; with several pytest workers sharing the
    cores, their threads spin against each other, and a CG loop of
    hundreds of such calls took 207 s in each of four processes run
    together (0.28 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(mat) -> CSRMatrix:
    return CSRMatrix(mat.indptr, mat.indices, mat.data, mat.shape)


def _host(t) -> np.ndarray:
    a = t.numpy()
    return a.view(np.uint16) if t.dtype == torch.bfloat16 else a


def _assert_same_stack(ours, ref):
    """Every stacked array and static field of the port's layout equals
    the reference's (uint32 deltas compared as the port's int32 view)."""
    if isinstance(ref, jsh.OverlapRanked):
        _assert_same_stack(ours.main, ref.main)
        _assert_same_stack(ours.edge, ref.edge)
        return
    arrays, static = ((_RANKED, _RANKED_STATIC)
                      if isinstance(ref, jsh.ShardedRanked)
                      else (_SELL, _SELL_STATIC))
    for name in arrays:
        a = np.asarray(getattr(ref, name))
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        b = _host(getattr(ours, name))
        if a.dtype.name == "bfloat16":
            a = a.view(np.uint16)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name
    for name in static:
        assert getattr(ours, name) == getattr(ref, name), name


def _jmesh(D):
    return jsh.make_row_mesh(jax.devices()[:D])


def _tmesh(D):
    return tsh.make_row_mesh(["cpu"] * D)


def _jvec(v, pm, mesh):
    out = np.zeros((pm, *v.shape[1:]), np.float32)
    out[: v.shape[0]] = v
    return jax.device_put(jnp.asarray(out), NamedSharding(mesh, P("rows")))


def _check(y, y_ref, y_jax):
    """Number Wrong 0 and RelL2 <= 1e-6 against the oracle and JAX."""
    for other in (y_ref, y_jax):
        wrong, rel = validate(y, other)
        assert wrong == 0 and rel <= 1e-6, (wrong, rel)


def _spmv_both(jlay, tlay, mat, D, x, overlap=False):
    """(port y, JAX y) over the first m rows."""
    jm, tm = _jmesh(D), _tmesh(D)
    jfn = jsh.spmv_overlap if overlap else jsh.spmv_sharded
    tfn = tsh.spmv_overlap if overlap else tsh.spmv_sharded
    yj = np.asarray(jfn(jlay.device_put(jm), _jvec(x, jlay.padded_m, jm),
                        jm))
    ys = tfn(tlay.device_put(tm), tsh.shard_vector(x, tm, tlay.padded_m), tm)
    assert len(ys) == D and all(t.shape[0] == tlay.rows_per_shard for t in ys)
    return tsh.gather_vector(ys), yj


def _x(n, seed, B=None):
    shape = (n,) if B is None else (n, B)
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_spmv_matches_oracle(n_dev):
    mat = random_banded(3000, 60, 8, seed=0)
    jl = jsh.ShardedSell.build(mat, n_dev)
    tl = tsh.ShardedSell.build(_port(mat), n_dev)
    _assert_same_stack(tl, jl)
    x = _x(mat.n, 0)
    y, yj = _spmv_both(jl, tl, mat, n_dev, x)
    _check(y[: mat.m], mat.matvec(x), yj[: mat.m])


def test_sharded_padding_rows_are_zero():
    mat = laplacian_2d(40)  # 1600 rows, not divisible by the shards
    jl = jsh.ShardedSell.build(mat, 8)
    tl = tsh.ShardedSell.build(_port(mat), 8)
    _assert_same_stack(tl, jl)
    x = np.ones(mat.n, np.float32)
    y, yj = _spmv_both(jl, tl, mat, 8, x)
    assert np.all(y[mat.m :] == 0.0) and np.all(yj[mat.m :] == 0.0)
    _check(y[: mat.m], mat.matvec(x), yj[: mat.m])


@pytest.mark.parametrize("mode", ["auto", "never"])
def test_halo_and_allgather_agree(mode):
    mat = random_banded(2500, 50, 8, seed=2)
    jl = jsh.ShardedSell.build(mat, 4, halo=mode)
    tl = tsh.ShardedSell.build(_port(mat), 4, halo=mode)
    _assert_same_stack(tl, jl)
    assert (tl.halo > 0) == (mode == "auto")
    x = _x(mat.n, 1)
    y, yj = _spmv_both(jl, tl, mat, 4, x)
    _check(y[: mat.m], mat.matvec(x), yj[: mat.m])


def _wide(mat, cls):
    """mat with one entry coupling row 0 to the last column."""
    indptr = mat.indptr.astype(np.int64).copy()
    indices = np.concatenate([[mat.m - 1], mat.indices]).astype(np.int32)
    data = np.concatenate([[1.0], mat.data]).astype(np.float32)
    indptr[1:] += 1
    return cls(indptr.astype(np.int32), indices, data, mat.shape)


def test_halo_fallback_on_wide_coupling():
    mat = random_banded(16384, 40, 6, seed=3)
    jw, tw = _wide(mat, JCSR), _wide(mat, CSRMatrix)
    jl, tl = jsh.ShardedSell.build(jw, 4), tsh.ShardedSell.build(tw, 4)
    assert tl.halo == 0
    _assert_same_stack(tl, jl)
    with pytest.raises(ValueError) as ref:
        jsh.ShardedSell.build(jw, 4, halo="always")
    with pytest.raises(ValueError) as ours:
        tsh.ShardedSell.build(tw, 4, halo="always")
    assert str(ours.value) == str(ref.value)


def test_rectangular_wider_than_padded_m_is_refused():
    rng = np.random.default_rng(0)
    args = (np.arange(0, 1025 * 4, 4).astype(np.int32),
            rng.integers(0, 5000, 1024 * 4).astype(np.int32),
            rng.standard_normal(1024 * 4).astype(np.float32), (1024, 5000))
    with pytest.raises(ValueError) as ref:
        jsh.ShardedRanked.build(JCSR(*args), 2)
    with pytest.raises(ValueError) as ours:
        tsh.ShardedRanked.build(CSRMatrix(*args), 2)
    assert str(ours.value) == str(ref.value)
    assert "exceeds padded_m=2048" in str(ours.value)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_ranked_matches_oracle(n_dev):
    mat = random_banded(3000, 60, 8, seed=0)
    jl = jsh.ShardedRanked.build(mat, n_dev)
    tl = tsh.ShardedRanked.build(_port(mat), n_dev)
    _assert_same_stack(tl, jl)
    assert tl.halo > 0
    x = _x(mat.n, 0)
    y, yj = _spmv_both(jl, tl, mat, n_dev, x)
    _check(y[: mat.m], mat.matvec(x), yj[: mat.m])


def test_padding_subtiles_are_never_walked():
    """The stack pads a shard of fewer sub-tiles with sub_chunk =
    num_chunks_local (the reference's sentinel). The shard's chunk,
    segment, run and window tables end at its real sub-tiles, so the
    kernels never walk the padding."""
    mat = random_banded(3000, 60, 8, seed=0)  # shards 3-7 hold no rows
    tl = tsh.ShardedRanked.build(_port(mat), 8)
    S = int(tl.sub_chunk.shape[1])
    padded = 0
    for d, shard in enumerate(tl.shards):
        real = int((tl.sub_chunk[d] < tl.num_chunks_local).sum())
        padded += real < S
        assert int(shard.chunk_ptr[-1]) == int(shard.seg_ptr[-1]) == real
        G = int(shard.seg_ptr.shape[0]) - 1
        assert int(shard.run_ptr[0, -1]) == G
        assert int(shard.step_seg[-1]) == G
    assert padded > 0


def test_one_shard_is_the_single_device_layout():
    """D = 1: no halo, one block of the whole matrix, the layout
    RankedSlabs.from_csr builds, and spmv_sharded gives spmv_ranked's
    bits on it."""
    from tpu_spmv_torch.formats.sell import RankedSlabs
    from tpu_spmv_torch.kernels.sell import spmv_ranked

    mat = _port(random_banded(3000, 60, 8, seed=0))
    tl = tsh.ShardedRanked.build(mat, 1)
    _assert_same_stack(tl, jsh.ShardedRanked.build(
        random_banded(3000, 60, 8, seed=0), 1))
    assert tl.halo == 0 and tl.shard_n == mat.n
    single = RankedSlabs.from_csr(CSRMatrix(
        np.concatenate([mat.indptr, np.full(tl.padded_m - mat.m,
                                            mat.indptr[-1])]),
        mat.indices, mat.data, (tl.padded_m, mat.n)))
    for name in _RANKED:
        assert torch.equal(getattr(tl.shards[0], name), getattr(single, name))
    x = _x(mat.n, 4)
    mesh = _tmesh(1)
    (y,) = tsh.spmv_sharded(tl.device_put(mesh),
                            tsh.shard_vector(x, mesh, tl.padded_m), mesh)
    assert torch.equal(y, spmv_ranked(single, torch.from_numpy(x)))


def test_shared_group_plan():
    """tests/test_dist.py's 8-shard matrix: shard 0's group plan is
    shared by every shard (group_code != 0), and the stack equals the
    reference's; the column-binned scattered stack falls back to no
    groups."""
    mat = random_banded(8192, 60, 8, seed=0)
    jl = jsh.ShardedRanked.build(mat, 8)
    tl = tsh.ShardedRanked.build(_port(mat), 8)
    assert tl.group_code != 0
    members = tl.shards[0].group_members
    assert sorted(r for g in members for r in g) == list(range(8))
    assert all(s.group_code == tl.group_code for s in tl.shards)
    _assert_same_stack(tl, jl)
    x = _x(mat.n, 0)
    y, yj = _spmv_both(jl, tl, mat, 8, x)
    _check(y[: mat.m], mat.matvec(x), yj[: mat.m])


def test_group_plan_is_validated_against_the_budget():
    """RankedSlabs.from_csr(group_plan=...) raises the reference's errors
    for a plan that is not a partition and for a member past the
    budget, and keeps a valid plan."""
    from tpu_spmv.formats.sell import RankedSlabs as JRanked
    from tpu_spmv_torch.formats.sell import RankedSlabs

    mat = random_banded(2048, 60, 8, seed=1)
    own = RankedSlabs.from_csr(_port(mat))
    assert own.group_code
    plan = own.group_members
    kept = RankedSlabs.from_csr(_port(mat), allow_groups=False,
                                group_plan=plan)
    ref = JRanked.from_csr(mat, allow_groups=False, group_plan=plan)
    assert kept.group_code == ref.group_code == own.group_code
    assert np.array_equal(kept.grp_b0.numpy(), np.asarray(ref.grp_b0))
    for bad, budget in ((((0, 1, 2, 3),), None), (plan, 1)):
        if budget == 1 and all(len(g) == 1 for g in plan):
            continue
        with pytest.raises(ValueError) as e_ref:
            JRanked.from_csr(mat, allow_groups=False, group_plan=bad,
                             group_plan_budget=budget)
        with pytest.raises(ValueError) as e_ours:
            RankedSlabs.from_csr(_port(mat), allow_groups=False,
                                 group_plan=bad, group_plan_budget=budget)
        assert str(e_ours.value) == str(e_ref.value)


def test_sharded_ranked_binned_scattered():
    mat = random_general(1200, 8, seed=5)
    jl = jsh.ShardedRanked.build(mat, 4, bin_blocks=4)
    tl = tsh.ShardedRanked.build(_port(mat), 4, bin_blocks=4)
    _assert_same_stack(tl, jl)
    assert tl.rank_nb <= 4
    x = _x(mat.n, 2)
    y, yj = _spmv_both(jl, tl, mat, 4, x)
    _check(y[: mat.m], mat.matvec(x), yj[: mat.m])


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _cg_both(jl, tl, mat, D, iters, b, inv=None):
    """(port x, JAX x) after `iters` CG (or Jacobi-PCG with inv)."""
    jm, tm = _jmesh(D), _tmesh(D)
    jb = _jvec(b, jl.padded_m, jm)
    tb = tsh.shard_vector(b, tm, tl.padded_m)
    jlay, tlay = jl.device_put(jm), tl.device_put(tm)
    if inv is None:
        xj, _ = jsolvers.cg_solve(jlay, jb, jm, iters=iters)
        xt, rz = tsolvers.cg_solve(tlay, tb, tm, iters=iters)
    else:
        xj, _ = jsolvers.pcg_solve(jlay, jb, jm, _jvec(inv, jl.padded_m, jm),
                                   iters=iters)
        xt, rz = tsolvers.pcg_solve(tlay, tb, tm,
                                    tsh.shard_vector(inv, tm, tl.padded_m),
                                    iters=iters)
    assert rz.dim() == 0 and np.isfinite(float(rz))
    xt = tsh.gather_vector(xt)
    assert np.all(xt[mat.m :] == 0.0)
    return xt[: mat.m], np.asarray(xj)[: mat.m]


def test_cg_converges_distributed():
    mat = random_banded(2000, 40, 8, seed=1)  # SPD by construction
    jl = jsh.ShardedSell.build(mat, 8)
    tl = tsh.ShardedSell.build(_port(mat), 8)
    b = np.ones(mat.m, np.float32)
    x, xj = _cg_both(jl, tl, mat, 8, 60, b)
    assert np.linalg.norm(mat.matvec(x) - b) / np.sqrt(mat.m) < 1e-4
    assert _rel(x, xj) <= 1e-4


def test_cg_on_ranked_layout():
    mat = random_banded(2000, 40, 8, seed=1)
    jl = jsh.ShardedRanked.build(mat, 8)
    tl = tsh.ShardedRanked.build(_port(mat), 8)
    b = np.ones(mat.m, np.float32)
    x, xj = _cg_both(jl, tl, mat, 8, 60, b)
    assert np.linalg.norm(mat.matvec(x) - b) / np.sqrt(mat.m) < 1e-4
    assert _rel(x, xj) <= 1e-4


def test_pcg_converges_faster_than_cg():
    """Jacobi-PCG on an ill-scaled SPD system D A D: with the same
    iterations, a smaller residual than plain CG; each holds to JAX's."""
    mat = random_banded(2000, 40, 8, seed=3)
    scale = np.exp(np.random.default_rng(0).uniform(-3, 3, mat.m)).astype(
        np.float32)
    rows = np.repeat(np.arange(mat.m), mat.row_lengths)
    data = mat.data * scale[rows] * scale[mat.indices]
    sm = JCSR(mat.indptr, mat.indices, data, mat.shape)
    jl = jsh.ShardedRanked.build(sm, 4)
    tl = tsh.ShardedRanked.build(_port(sm), 4)
    inv = tsolvers.jacobi_inv_diag(sm.diagonal(), sm.m)
    b = np.ones(sm.m, np.float32)
    x_cg, xj_cg = _cg_both(jl, tl, sm, 4, 40, b)
    x_pcg, xj_pcg = _cg_both(jl, tl, sm, 4, 40, b, inv)
    r_cg = np.linalg.norm(sm.matvec(x_cg) - 1.0)
    r_pcg = np.linalg.norm(sm.matvec(x_pcg) - 1.0)
    assert r_pcg < r_cg, (r_pcg, r_cg)
    assert _rel(x_pcg, xj_pcg) <= 1e-4
    # Plain CG on this system (diagonal scales e^-3..e^3 on each side) is
    # far from converged after 40 iterations, and the dots' other order of
    # summation shows: 1.6e-3 here, so this one case is held to 1e-2.
    assert _rel(x_cg, xj_cg) <= 1e-2


def test_jacobi_inv_diag_is_the_reference_scaling():
    diag = np.asarray([2.0, -4.0, 0.0, 0.5], np.float32)
    assert np.array_equal(tsolvers.jacobi_inv_diag(diag, 6),
                          np.asarray([0.5, -0.25, 1.0, 2.0, 0, 0], np.float32))


def _spmm_both(jl, tl, D, X, kernel="auto", overlap=False):
    jm, tm = _jmesh(D), _tmesh(D)
    Xj = _jvec(X, jl.padded_m, jm)
    Xs = tsh.shard_vector(X, tm, tl.padded_m)
    if overlap:
        Yj = jsh.spmm_overlap(jl.device_put(jm), Xj, jm)
        Ys = tsh.spmm_overlap(tl.device_put(tm), Xs, tm)
    else:
        Yj = jsh.spmm_sharded(jl.device_put(jm), Xj, jm, kernel=kernel)
        Ys = tsh.spmm_sharded(tl.device_put(tm), Xs, tm, kernel=kernel)
    return tsh.gather_vector(Ys), np.asarray(Yj)


def _oracle(mat, X):
    return np.stack([mat.matvec(X[:, b]) for b in range(X.shape[1])], 1)


def test_spmm_sharded_matches_oracle():
    mat = random_banded(3000, 60, 8, seed=0)
    jl = jsh.ShardedRanked.build(mat, 4)
    tl = tsh.ShardedRanked.build(_port(mat), 4)
    assert tl.halo > 0
    X = _x(mat.n, 3, B=4)
    Y, Yj = _spmm_both(jl, tl, 4, X)
    _check(Y[: mat.m], _oracle(mat, X), Yj[: mat.m])


def test_spmm_sharded_windowed_matches_resident():
    mat = random_banded(3000, 60, 8, seed=2)
    jl = jsh.ShardedRanked.build(mat, 4)
    tl = tsh.ShardedRanked.build(_port(mat), 4)
    assert tl.win_w > 0
    X = _x(mat.n, 5, B=3)
    Y_res, Yj = _spmm_both(jl, tl, 4, X, "resident")
    Y_win, _ = _spmm_both(jl, tl, 4, X, "windowed")
    _check(Y_win[: mat.m], _oracle(mat, X), Yj[: mat.m])
    np.testing.assert_array_equal(Y_win, Y_res)


def test_spmm_sharded_auto_takes_windowed_past_the_gate(monkeypatch):
    """auto decides per shard by resident_x_fits: with no L2 to speak
    of, every shard takes spmm_ranked_windowed."""
    from tpu_spmv_torch import hw
    from tpu_spmv_torch.kernels import spmm

    mat = _port(random_banded(3000, 60, 8, seed=2))
    tm = _tmesh(2)
    tl = tsh.ShardedRanked.build(mat, 2).device_put(tm)
    X = _x(mat.n, 5, B=3)
    Xs = tsh.shard_vector(X, tm, tl.padded_m)
    calls = []
    real = spmm.spmm_ranked_windowed_reference
    monkeypatch.setattr(spmm, "spmm_ranked_windowed_reference",
                        lambda lay, x: calls.append(1) or real(lay, x))
    monkeypatch.setattr(hw, "H100_L2_BYTES", 0)
    Y = tsh.gather_vector(tsh.spmm_sharded(tl, Xs, tm))[: mat.m]
    assert len(calls) == 2
    wrong, rel = validate(Y, _oracle(mat, X))
    assert wrong == 0 and rel <= 1e-6
    tl.win_w = 0
    with pytest.raises(ValueError, match="no per-tile windows"):
        tsh.spmm_sharded(tl, Xs, tm)


def test_sharded_ranked_uniform_tile_windowed_spmm():
    """Shards of uneven density pick different tiles on their own (1024
    and 512 here); the stack rebuilds them at one tile, equal to the
    reference's, and the windowed SpMM agrees."""
    from tpu_spmv.formats.sell import RankedSlabs as JRanked

    rng = np.random.default_rng(0)
    m = 16384
    rows, cols = [], []
    for r in range(m):
        deg = 30 if r < m // 2 else 4
        c = np.unique(np.clip(r + rng.integers(-60, 61, size=deg), 0, m - 1))
        rows.extend([r] * len(c))
        cols.extend(c.tolist())
    mat = JCSR.from_coo(rows, cols,
                        rng.standard_normal(len(rows)).astype(np.float32),
                        (m, m))
    blocks, _, _ = tsh._slice_shard_blocks(_port(mat), 2, "auto")
    from tpu_spmv_torch.formats.sell import RankedSlabs

    assert len({RankedSlabs.from_csr(b).tile_k for b in blocks}) > 1
    assert len({JRanked.from_csr(b).tile_k for b in jsh._slice_shard_blocks(
        mat, 2, "auto")[0]}) > 1
    jl = jsh.ShardedRanked.build(mat, 2)
    tl = tsh.ShardedRanked.build(_port(mat), 2)
    _assert_same_stack(tl, jl)
    X = rng.standard_normal((m, 2)).astype(np.float32)
    Y, Yj = _spmm_both(jl, tl, 2, X, "windowed")
    _check(Y[:m], _oracle(mat, X), Yj[:m])


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_overlap_spmv_matches_oracle(n_dev):
    mat = random_banded(3000, 60, 8, seed=0)
    jl = jsh.OverlapRanked.build(mat, n_dev)
    tl = tsh.OverlapRanked.build(_port(mat), n_dev)
    _assert_same_stack(tl, jl)
    real = int((tl.main.vals != 0).sum()) + int((tl.edge.vals != 0).sum())
    assert real == mat.nnz and 0 < tl.edge.nnz < mat.nnz // 4
    x = _x(mat.n, 0)
    y, yj = _spmv_both(jl, tl, mat, n_dev, x, overlap=True)
    _check(y[: mat.m], mat.matvec(x), yj[: mat.m])


def test_overlap_empty_edges():
    """Block-diagonal: no column leaves its shard, every edge stack is
    empty of nonzeros, and the overlap still runs and agrees."""
    rng = np.random.default_rng(7)
    blocks = [random_banded(1024, 30, 6, seed=int(rng.integers(1 << 30)))
              .to_scipy() for _ in range(4)]
    mat = JCSR.from_scipy(sp.block_diag(blocks, format="csr"))
    jl = jsh.OverlapRanked.build(mat, 4)
    tl = tsh.OverlapRanked.build(_port(mat), 4)
    assert tl.edge.nnz == 0
    _assert_same_stack(tl, jl)
    x = _x(mat.n, 0)
    y, yj = _spmv_both(jl, tl, mat, 4, x, overlap=True)
    _check(y[: mat.m], mat.matvec(x), yj[: mat.m])


def test_overlap_build_rejects_nonbanded():
    rng = np.random.default_rng(0)
    args = (np.arange(0, 4097 * 4, 4).astype(np.int32),
            rng.integers(0, 256, 4096 * 4).astype(np.int32),
            rng.standard_normal(4096 * 4).astype(np.float32), (4096, 256))
    sq = random_banded(2000, 50, 8, seed=0)
    for jmat, tmat, D in ((JCSR(*args), CSRMatrix(*args), 4),
                          (sq, _port(sq), 1)):
        with pytest.raises(ValueError) as ref:
            jsh.OverlapRanked.build(jmat, D)
        with pytest.raises(ValueError, match="banded neighbor halo") as ours:
            tsh.OverlapRanked.build(tmat, D)
        assert str(ours.value) == str(ref.value)


def test_mesh_of_another_size_is_refused():
    mat = _port(random_banded(3000, 60, 8, seed=0))
    lay = tsh.ShardedRanked.build(mat, 4)
    with pytest.raises(ValueError, match="built for 4 shards but axis "
                       "'rows' spans 2 devices"):
        lay.device_put(_tmesh(2))
    mesh = _tmesh(4)
    placed = lay.device_put(mesh)
    xs = tsh.shard_vector(np.zeros(placed.padded_m, np.float32), mesh)
    with pytest.raises(ValueError, match="spans 2 devices"):
        tsh.spmv_sharded(placed, xs, _tmesh(2))


# The (hosts, rows) mesh: tests/test_dist.py's four hybrid cases, the
# JAX side on tpu_spmv.dist.multihost's (2, 4) mesh of the virtual
# devices, the port on multihost.make_hybrid_mesh over ["cpu"] * 8, both
# sharding rows over the tuple axis.

_HYBRID = ("hosts", "rows")


def _hybrid_both(jl, tl, X, call):
    """(port Y, JAX Y) of `call` ("spmv_sharded", "spmm_sharded" or
    "spmv_overlap") over the hybrid meshes."""
    from tpu_spmv.dist.multihost import make_hybrid_mesh as jhybrid
    from tpu_spmv_torch.dist.multihost import make_hybrid_mesh

    jm = jhybrid(num_hosts=2)
    tm = make_hybrid_mesh(num_hosts=2, devices=["cpu"] * 8)
    assert jm.devices.shape == tm.shape == (2, 4)
    out = np.zeros((jl.padded_m, *X.shape[1:]), np.float32)
    out[: X.shape[0]] = X
    Xj = jsh.shard_vector(out, jm, _HYBRID)
    Yj = getattr(jsh, call)(jl.device_put(jm, _HYBRID), Xj, jm, _HYBRID)
    Ys = getattr(tsh, call)(tl.device_put(tm, _HYBRID),
                            tsh.shard_vector(X, tm, tl.padded_m), tm,
                            _HYBRID)
    return tsh.gather_vector(Ys), np.asarray(Yj)


def test_hybrid_mesh_spmv_and_groups():
    """Rows sharded over the flattened (hosts, rows) axes, the halo pairs
    crossing the host boundary, and the shared group plan across all
    eight shards."""
    mat = random_banded(8192, 60, 8, seed=0)
    jl = jsh.ShardedRanked.build(mat, 8)
    tl = tsh.ShardedRanked.build(_port(mat), 8)
    _assert_same_stack(tl, jl)
    assert tl.halo > 0 and tl.group_code != 0
    x = _x(mat.n, 0)
    y, yj = _hybrid_both(jl, tl, x, "spmv_sharded")
    _check(y[: mat.m], mat.matvec(x), yj[: mat.m])


def test_hybrid_mesh_axis_size_guard():
    """Naming only the "rows" sub-axis (4 devices) of the (2, 4) mesh:
    the 8-shard layout is refused with the reference's message; a name
    the mesh lacks raises, as the reference's mesh.shape[name] does."""
    from tpu_spmv_torch.dist.multihost import make_hybrid_mesh

    mesh = make_hybrid_mesh(num_hosts=2, devices=["cpu"] * 8)
    lay = tsh.ShardedRanked.build(_port(random_banded(8192, 60, 8, seed=0)),
                                  8).device_put(mesh, _HYBRID)
    xs = tsh.shard_vector(np.zeros(lay.padded_m, np.float32), mesh)
    with pytest.raises(ValueError, match="spans 4 devices"):
        tsh.spmv_sharded(lay, xs, mesh, "rows")
    with pytest.raises(ValueError, match="spans 4 devices"):
        lay.device_put(mesh, "rows")
    with pytest.raises(KeyError, match="no axis 'row'"):
        tsh.spmv_sharded(lay, xs, mesh, ("hosts", "row"))
    assert tsh.gather_vector(tsh.spmv_sharded(lay, xs, mesh, _HYBRID)).shape \
        == (lay.padded_m,)


def test_spmm_sharded_hybrid_mesh():
    mat = random_banded(8192, 60, 8, seed=1)
    jl = jsh.ShardedRanked.build(mat, 8)
    tl = tsh.ShardedRanked.build(_port(mat), 8)
    X = _x(mat.n, 4, B=2)
    Y, Yj = _hybrid_both(jl, tl, X, "spmm_sharded")
    _check(Y[: mat.m], _oracle(mat, X), Yj[: mat.m])


def test_overlap_hybrid_mesh():
    """The overlap over the tuple axis: the edge copies cross the host
    boundary as spmv_sharded's do."""
    mat = random_banded(9000, 50, 8, seed=3)
    jl = jsh.OverlapRanked.build(mat, 8)
    tl = tsh.OverlapRanked.build(_port(mat), 8)
    _assert_same_stack(tl, jl)
    x = _x(mat.n, 1)
    y, yj = _hybrid_both(jl, tl, x, "spmv_overlap")
    _check(y[: mat.m], mat.matvec(x), yj[: mat.m])


def test_cg_on_overlap_layout():
    mat = random_banded(2000, 50, 8, seed=2)
    jl = jsh.OverlapRanked.build(mat, 4)
    tl = tsh.OverlapRanked.build(_port(mat), 4)
    assert tl.edge.nnz > 0
    b = np.ones(mat.m, np.float32)
    x, xj = _cg_both(jl, tl, mat, 4, 120, b)
    assert np.linalg.norm(mat.matvec(x) - b) / np.sqrt(mat.m) < 1e-4
    assert _rel(x, xj) <= 1e-4


def test_spmm_overlap_matches_oracle():
    mat = random_banded(2000, 50, 8, seed=4)
    jl = jsh.OverlapRanked.build(mat, 4)
    tl = tsh.OverlapRanked.build(_port(mat), 4)
    assert tl.edge.nnz > 0
    X = _x(mat.n, 0, B=3)
    Y, Yj = _spmm_both(jl, tl, 4, X, overlap=True)
    _check(Y[: mat.m], _oracle(mat, X), Yj[: mat.m])


@pytest.mark.parametrize("kind", ["ShardedSell", "ShardedRanked",
                                  "OverlapRanked"])
def test_from_reference_runs_the_reference_layout(kind):
    """A layout built by tpu_spmv.dist.sharding, carried across by
    formats.convert.from_reference, gives the port's spmv_sharded (or
    spmv_overlap) result on the port's own build, bit for bit."""
    from tpu_spmv_torch.formats.convert import from_reference

    mat = random_banded(3000, 60, 8, seed=0)
    jl = getattr(jsh, kind).build(mat, 4)
    ours = getattr(tsh, kind).build(_port(mat), 4)
    carried = from_reference(jl)
    _assert_same_stack(carried, jl)
    mesh = _tmesh(4)
    fn = tsh.spmv_overlap if kind == "OverlapRanked" else tsh.spmv_sharded
    x = tsh.shard_vector(_x(mat.n, 6), mesh, ours.padded_m)
    y1 = tsh.gather_vector(fn(carried.device_put(mesh), x, mesh))
    y2 = tsh.gather_vector(fn(ours.device_put(mesh), x, mesh))
    assert np.array_equal(y1, y2)


def test_dist_exports():
    import tpu_spmv.dist as jdist
    import tpu_spmv_torch.dist as tdist

    for name in ("OverlapRanked", "ShardedRanked", "ShardedSell",
                 "make_row_mesh", "spmm_overlap", "spmm_sharded",
                 "spmv_overlap", "spmv_sharded", "cg_solve", "pcg_solve",
                 "ShardedLowerSolve", "sts_solve_sharded"):
        assert hasattr(jdist, name) and hasattr(tdist, name), name


def run_cli(main, argv):
    """(exit code, stdout) of a CLI's main(argv)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _lines(out, *keys):
    return [ln for ln in out.splitlines() if any(k in ln for k in keys)]


def residual(out) -> float:
    return float(re.search(r"rms_residual=(\S+)", out).group(1))


def assert_solve_cli_agrees(argv, iters=2):
    """tools.solve of both packages on argv (--iters iters): the same exit
    code, the same route lines (devices, overlap split, ignored options,
    ic0), and RMS residuals within 1e-3 of each other, relatively. Two
    iterations by default: CG amplifies rounding, and a few iterations on
    these matrices already part runs of one package at another D by 5%
    (the JAX CLI's own D = 1 and D = 4 on banded_mtx, after 8); at
    --iters 60 both reach the default --tol, so there only the exit codes
    (0) and the lines are compared."""
    from tpu_spmv.tools import solve as jcli
    from tpu_spmv_torch.tools import solve as tcli

    argv = [*argv, "--iters", str(iters)]
    rc_j, out_j = run_cli(jcli.main, argv)
    rc_t, out_t = run_cli(tcli.main, [*argv, "--device", "cpu"])
    assert rc_t == rc_j, (out_t, out_j)
    keys = ("devices=", "overlap", "ignored", "ic0: rows", "ic0-bj", "RCM",
            "D=")
    assert _lines(out_t, *keys) == _lines(out_j, *keys), (out_t, out_j)
    r_t, r_j = residual(out_t), residual(out_j)
    if iters >= 60:
        assert rc_t == 0, out_t
    else:
        assert abs(r_t - r_j) <= 1e-3 * r_j, (r_t, r_j)
    return out_t


@pytest.fixture(scope="module")
def banded_mtx(tmp_path_factory):
    """A 4,000-row SPD banded matrix as a .mtx file: at 4 shards of 1,024
    rows, the band crosses every shard boundary."""
    from tpu_spmv.io import write_mtx

    path = tmp_path_factory.mktemp("mtx") / "banded_4000.mtx"
    write_mtx(str(path), random_banded(4000, 40, 8, seed=3))
    return str(path)


@pytest.mark.parametrize("args", [
    ["--devices", "4"],
    ["--pcg", "--devices", "2"],
    ["--overlap", "--devices", "4"],
    ["--overlap", "--precond", "jacobi", "--devices", "8"],
    ["--overlap", "--devices", "1"],
])
def test_solve_cli_sharded(args, banded_mtx):
    out = assert_solve_cli_agrees([banded_mtx, *args])
    if "--overlap" in args and "1" not in args:
        assert "overlap split: edge nnz = " in out
    assert_solve_cli_agrees([banded_mtx, *args], iters=60)


def test_solve_cli_overlap_falls_back_when_the_halo_does_not_apply(tmp_path):
    """A matrix whose columns reach past the neighbours: --overlap prints
    the reference's fall-back line and runs spmv_sharded's all-gather."""
    from tpu_spmv.io import write_mtx

    path = str(tmp_path / "wide.mtx")
    mat = random_banded(8192, 40, 8, seed=3)
    # Symmetric far coupling keeps the matrix SPD (diagonally dominant).
    rows = np.repeat(np.arange(mat.m), mat.row_lengths)
    coo = sp.coo_matrix((mat.data, (rows, mat.indices)), shape=mat.shape)
    far = sp.coo_matrix(([0.01, 0.01], ([0, mat.m - 1], [mat.m - 1, 0])),
                        shape=mat.shape)
    write_mtx(path, JCSR.from_scipy((coo + far).tocsr()))
    out = assert_solve_cli_agrees([path, "--overlap", "--devices", "4",
                                   "--rcm", "never"])
    assert "overlap unavailable (" in out and "devices=4 halo=0" in out


@pytest.mark.parametrize("args", [
    ["--devices", "2"],
    ["--devices", "4", "--overlap"],
    ["--devices", "2", "--kernel", "windowed"],
    ["--devices", "2", "--val-dtype", "bf16"],
])
def test_spmm_cli_sharded(args, banded_mtx):
    """tools.spmm --devices against the JAX CLI: the same route lines,
    Number Wrong 0 in both."""
    from tpu_spmv.tools import spmm as jcli
    from tpu_spmv_torch.tools import spmm as tcli

    argv = [banded_mtx, "--batch", "3", *args, "--validate-only"]
    rc_j, out_j = run_cli(jcli.main, argv)
    rc_t, out_t = run_cli(tcli.main, [*argv, "--device", "cpu"])
    assert rc_t == rc_j == 0, (out_t, out_j)
    keys = ("devices=", "overlap", "per-shard", "bf16")
    assert _lines(out_t, *keys) == _lines(out_j, *keys), (out_t, out_j)
    assert "Number Wrong: 0 " in out_t
    rel = float(re.search(r"RelL2: (\S+)", out_t).group(1))
    assert rel <= (1e-2 if "bf16" in args else 1e-6)


def test_cli_devices_past_the_cards_are_refused(monkeypatch):
    from tpu_spmv_torch.tools import solve as tcli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="requested 2 devices, only 1 "
                       "available"):
        tcli.main(["synthetic:banded_1k", "--devices", "2"])
