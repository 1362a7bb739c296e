"""The port's IC(0)-PCG against the JAX package's.

ic0_factor is the same native routine (or the same NumPy twin), so the
factors are bit-equal. IC0Preconditioner.apply (two plain solves on the
CPU) is held against JAX's apply in Pallas interpret mode and against
scipy's two triangular solves in f64, RelL2 <= 1e-6 as
tests/test_ic0.py holds the reference. pcg_ic0_solve follows JAX's loop
to RelL2 <= 1e-4 in x after 10 iterations (both in f32; the two
packages' solves round differently, and CG amplifies the difference).
The solve CLI runs on the CPU and refuses what runs over the
distributed layer, naming ROADMAP item A13.
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
    ["--precond", "ic0", "--devices", "2"],
])
def test_solve_cli_refusals(args):
    from tpu_spmv_torch.tools import solve

    with pytest.raises(SystemExit) as e:
        solve.main(["synthetic:banded_1k", *args, "--device", "cpu"])
    assert "ROADMAP.md item A13" in str(e.value)


def test_solve_cli_needs_a_card(monkeypatch):
    from tpu_spmv_torch.tools import solve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        solve.main(["synthetic:banded_1k", "--precond", "ic0"])
