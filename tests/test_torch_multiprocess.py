"""The port's distributed layer across two real processes: the
counterpart of tests/test_multiprocess.py.

One module-scoped spawn (tpu_spmv_torch.bench.multiproc) starts two OS
processes on a free port, wired through dist/multihost.initialize: rank
0 gets the coordinator, count and rank as arguments, rank 1 through the
reference's TPU_SPMV_* variables. Each process runs on the CPU (gloo),
holds two of four shards on the (hosts=2, rows=2) mesh, builds the same
host layouts from the same seeds and runs the suite "small": on
tests/test_multiprocess.py's random_banded(2048 * 4, 60, 8, seed=0)
spmv_sharded (the halo exchange and, halo="never", x gathered whole),
a 3-iteration cg_solve, spmm_sharded at B = 3 and spmv_overlap; then
sts_solve_sharded on tests/test_dist_sts.py's system and exact and
block-Jacobi pcg_ic0_sharded on tests/test_ic0.py's. Each writes its
own rows. The cases, one a path, then hold each process's rows to:
  * the oracle: the serial SpMV at RelL2 <= 1e-6; the solves at 1e-5
    (CG against three float64 CG iterations, the triangular solve
    against the float64 substitution, PCG against the float64 solution);
  * the one-process port on ["cpu"] * 4 (the same run_paths), bit for
    bit: the dots are summed in shard order on every process and every
    exchange moves the same values;
  * for SpMV and SpMM, the JAX spmv_sharded / spmm_sharded on
    tests/conftest.py's virtual devices at 1e-6.
"""

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

from test_torch_dist import one_thread  # noqa: F401 (a fixture)
from tpu_spmv_torch.bench import multiproc
from tpu_spmv_torch.dist import sharding as tsh
from tpu_spmv_torch.sts.solve import lower_solve_reference

PATHS = ("spmv", "spmv_allgather", "spmm", "overlap", "cg", "sts", "ic0",
         "ic0_bj")
# A two-process run takes ~10 s on 2 cores; the limit is for a hang.
WALL_S = 240


@pytest.fixture(scope="module")
def run(tmp_path_factory, one_thread):  # noqa: F811
    """(per rank (facts, rows), the suite's host inputs, the one-process
    port's result on ["cpu"] * 4)."""
    out = str(tmp_path_factory.mktemp("multiproc"))
    res = multiproc.spawn(2, ["--suite", "small", "--device", "cpu",
                              "--check"], out, WALL_S, args_ranks=(0,))
    for r, (code, log) in enumerate(res):
        assert code == 0 and f"OK process {r}" in log, (r, code, log)
    built = multiproc.build("small")
    one, _ = multiproc.run_paths(built, tsh.make_row_mesh(["cpu"] * 4))
    return multiproc.load(out, 2), built, one


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _cg_f64(mat, b, iters):
    A = mat.to_scipy().astype(np.float64)
    x = np.zeros_like(b)
    r = b.copy()
    p = r.copy()
    rz = r @ r
    for _ in range(iters):
        Ap = A @ p
        alpha = rz / max(p @ Ap, 1e-30)
        x += alpha * p
        r -= alpha * Ap
        rz_new = r @ r
        p = r + rz_new / max(rz, 1e-30) * p
        rz = rz_new
    return x


def _oracle(built, path):
    """(the oracle over the path's padded rows, rows a shard, tolerance)."""
    if path == "sts":
        lay = built.sts_layout
        x = np.zeros(lay.padded_m)
        x[built.sts_pad] = lower_solve_reference(built.sts, built.sts_b)
        return x, lay.rows_per_shard, 1e-5
    if path in ("ic0", "ic0_bj"):
        lay, A = built.ic0_layout, built.ic0.to_scipy().astype(np.float64)
        ref, tol = spla.spsolve(A.tocsc(), np.ones(built.ic0.m)), 1e-5
    elif path == "cg":
        lay, ref, tol = built.cg_layout, _cg_f64(built.cg,
                                                 np.ones(built.cg.m), 3), 1e-5
    else:
        a, lay, tol = built.spmv, built.ranked, 1e-6
        v = built.X if path == "spmm" else built.x
        ref = np.stack([a.matvec(c) for c in v.reshape(a.n, -1).T], 1)
        ref = ref.reshape((a.m, *v.shape[1:]))
    padded = np.zeros((lay.padded_m, *ref.shape[1:]))
    padded[: ref.shape[0]] = ref
    return padded, lay.rows_per_shard, tol


@pytest.mark.parametrize("how", ["args", "env"])
def test_initialize_in_each_process(run, how):
    """initialize() started the group (True) and returned True again, in
    the process that got the group's facts as arguments and in the one
    that read them from the environment; the group is gloo on the CPU
    and the hybrid mesh (2, 2), rank r holding shards 2r and 2r + 1."""
    (facts,) = [f for f, _ in run[0] if f["how"] == how]
    assert facts["initialize"] == [True, True]
    assert facts["world"] == 2 and facts["backend"] == "gloo"
    assert facts["mesh_shape"] == [2, 2]
    r = facts["rank"]
    assert facts["local"] == [2 * r, 2 * r + 1]


def test_the_exchange_crosses_the_process_boundary(run):
    """A banded matrix takes the halo exchange, whose pair (shards 1 and
    2) crosses the processes; the overlap's edge has nonzeros; halo
    "never" gathers x whole; the kernels' plain versions are the
    kernels on the CPU."""
    for facts, _ in run[0]:
        paths = facts["paths"]
        assert paths["spmv"]["halo"] > 0 and paths["overlap"]["halo"] > 0
        assert paths["overlap"]["edge_nnz"] > 0
        assert paths["spmv_allgather"]["halo"] == 0
        for name in ("spmv", "spmm", "overlap", "sts", "ic0", "ic0_bj"):
            assert paths[name]["plain"][0] == 0.0, name


@pytest.mark.parametrize("path", PATHS)
def test_rows_match_the_oracle(run, path):
    loaded, built, _ = run
    ref, R, tol = _oracle(built, path)
    seen = []
    for facts, rows in loaded:
        got = rows[path]
        assert sorted(got) == facts["local"]
        mine = np.concatenate([got[d] for d in sorted(got)])
        want = np.concatenate([ref[d * R:(d + 1) * R] for d in sorted(got)])
        assert _rel(mine, want) <= tol, (facts["rank"], path)
        seen += sorted(got)
    assert seen == [0, 1, 2, 3]


@pytest.mark.parametrize("path", PATHS)
def test_rows_match_one_process(run, path):
    """Each process's rows are the one-process port's, bit for bit."""
    loaded, _, one = run
    for facts, rows in loaded:
        for d, got in rows[path].items():
            assert np.array_equal(got, one[path][d].numpy()), (path, d)


@pytest.mark.parametrize("path", ["spmv", "spmm"])
def test_rows_match_jax(run, path):
    """The JAX package's spmv_sharded / spmm_sharded on a (hosts=2,
    rows=2) mesh of the virtual devices, at 1e-6."""
    import jax
    from jax.sharding import Mesh

    from tpu_spmv.bench.matrices import random_banded
    from tpu_spmv.dist import sharding as jsh

    loaded, built, _ = run
    mat = random_banded(2048 * 4, 60, 8, seed=0)
    assert np.array_equal(mat.indices, built.spmv.indices)
    axis = ("hosts", "rows")
    jm = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), axis)
    jl = jsh.ShardedRanked.build(mat, 4).device_put(jm, axis)
    v = built.X if path == "spmm" else built.x
    vp = np.zeros((jl.padded_m, *v.shape[1:]), np.float32)
    vp[: v.shape[0]] = v
    yj = np.asarray(getattr(jsh, f"{path}_sharded")(
        jl, jsh.shard_vector(vp, jm, axis), jm, axis))
    R = jl.rows_per_shard
    for facts, rows in loaded:
        for d, got in rows[path].items():
            assert _rel(got, yj[d * R:(d + 1) * R]) <= 1e-6, (path, d)


@pytest.mark.parametrize("identities,want", [
    (["h/cpu", "h/cpu"], "gloo"),
    (["h/cuda/a", "h/cuda/b", "g/cuda/a"], "nccl"),
    (["h/cuda/a", "h/cuda/a"], "gloo"),
    (["h/cuda/a", "h/cpu"], "gloo"),
], ids=["cpu", "a-card-each", "a-shared-card", "mixed"])
def test_backend_rule(identities, want):
    """gloo on the CPU, NCCL when every process has a card of its own,
    gloo when two share one: every process reads the same identities and
    takes the same backend."""
    from tpu_spmv_torch.dist.multihost import choose_backend

    assert choose_backend(identities) == want


def test_gather_vector_needs_the_mesh_for_remote_shards():
    with pytest.raises(ValueError, match="pass the mesh"):
        tsh.gather_vector([torch.zeros(2), None])
    assert tsh.gather_vector([torch.ones(2), torch.zeros(1)]).tolist() == \
        [1.0, 1.0, 0.0]


def test_info_prints_the_process_facts(capsys):
    """One process without a group: 1 and 0, as the reference's
    collect() gives jax's process_count and process_index."""
    from tpu_spmv_torch.tools import info

    info.main([])
    out = capsys.readouterr().out
    assert "process_count: 1\n" in out and "process_index: 0\n" in out
