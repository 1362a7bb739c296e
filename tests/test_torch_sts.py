"""The port's triangular-solve path against the JAX package's.

Same matrix in, same schedule and layout out: `build_sts` and
`LowerSolveLayout.build` are held array-equal to the reference's
(including the ranked-or-binned choice). The plain solves (what the
wrappers run on a CPU tensor) are held against JAX's `lower_solve` in
Pallas interpret mode and against the f64 serial oracle: RelL2 <= 1e-5
(both solve in f32, in different orders, and errors grow along the
dependency chain) and Number Wrong 0 at 0.01 for x = ones. The CLIs run
on the CPU, and the options the port does not run are refused naming
their ROADMAP item.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.linalg import spsolve_triangular

from tpu_spmv.bench.matrices import laplacian_2d, random_banded, random_general
from tpu_spmv.formats.csr import CSRMatrix
from tpu_spmv.sts import host as jhost
from tpu_spmv.sts import solve as jsolve

from test_torch_formats import assert_same_layout
from tpu_spmv_torch.kernels.sts import (
    lower_solve_blocks, lower_solve_blocks_reference, lower_solve_ranked,
    lower_solve_ranked_reference, solve_steps,
)
from tpu_spmv_torch.sts import host as thost
from tpu_spmv_torch.sts import solve as tsolve

# The JAX suite's sizes (tests/test_sts.py): its solve runs in Pallas
# interpret mode, which dispatches per sub-tile.
MATS = {
    "lap2d": lambda: laplacian_2d(12),
    "banded": lambda: random_banded(200, 18, 6, seed=1),
    "general": lambda: random_general(100, 4, seed=2),
}
SYSTEMS = {
    "lap2d_LS": ("lap2d", dict(order_type="LS")),
    "lap2d_COLOR": ("lap2d", dict(order_type="COLOR")),
    "banded_LS": ("banded", dict(order_type="LS")),
    "banded_COLOR": ("banded", dict(order_type="COLOR")),
    "banded_LS_k3": ("banded", dict(order_type="LS", k=3, sup_row_sizes=(8,))),
    "general_COLOR_k3": ("general", dict(order_type="COLOR", k=3,
                                         sup_row_sizes=(8,))),
    "general_LS_unsorted": ("general", dict(order_type="LS",
                                            sort_packs=False)),
}


def _binned():
    """Level-scheduled random band: the level permutation scatters each
    row's parents over all earlier packs, so the binned windows engage
    (tests/test_sts.py::test_scattered_dependencies_use_binned_path)."""
    return random_banded(1536, 200, 8, seed=0)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _assert_same_system(ref, port):
    for name in ("matrix", "lower", "upper"):
        a, b = getattr(ref, name), getattr(port, name)
        for f in ("indptr", "indices", "data"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), (name, f)
        assert a.shape == b.shape
    assert np.array_equal(ref.perm, port.perm)
    assert np.array_equal(ref.pack_ptr, port.pack_ptr)
    assert (ref.order_type, ref.k) == (port.order_type, port.k)


def _assert_same_solve_layout(ref, port):
    assert_same_layout(ref.slabs, port.slabs)
    assert (ref.ranked is None) == (port.ranked is None)
    if ref.ranked is not None:
        assert_same_layout(ref.ranked, port.ranked)
    for f in ("b_scale", "inv_diag", "pad_index"):
        a, b = np.asarray(getattr(ref, f)), getattr(port, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert ref.m == port.m


@pytest.mark.parametrize("case", sorted(SYSTEMS))
def test_build_sts_matches_reference(case):
    name, kw = SYSTEMS[case]
    mat = MATS[name]()
    _assert_same_system(jhost.build_sts(mat, **kw), thost.build_sts(mat, **kw))


def test_host_helpers_match_reference():
    mat = MATS["general"]()
    for fn in ("find_levels", "greedy_color"):
        assert np.array_equal(getattr(jhost, fn)(mat.indptr, mat.indices),
                              getattr(thost, fn)(mat.indptr, mat.indices))
    for a, b in zip(jhost.split_lu(mat), thost.split_lu(mat)):
        assert np.array_equal(a.indices, b.indices)
        assert np.array_equal(a.data, b.data)
    r_mat, r_rev = thost.reversed_for_upper(mat)
    j_mat, j_rev = jhost.reversed_for_upper(mat)
    assert np.array_equal(r_rev, j_rev)
    assert np.array_equal(r_mat.indices, j_mat.indices)
    sys_ = thost.build_sts(mat)
    assert np.array_equal(thost.compute_b(sys_.lower),
                          jhost.compute_b(sys_.lower))
    x = np.linspace(0.5, 1.5, mat.m)
    assert thost.check_error(x) == jhost.check_error(x)


@pytest.mark.parametrize("ranked", [True, False], ids=["ranked", "blocks"])
@pytest.mark.parametrize("case", sorted(SYSTEMS))
def test_solve_layout_matches_reference(case, ranked):
    name, kw = SYSTEMS[case]
    sys_ = thost.build_sts(MATS[name](), **kw)
    b = thost.compute_b(sys_.lower)
    ref = jsolve.LowerSolveLayout.build(sys_, b, ranked=ranked)
    port = tsolve.LowerSolveLayout.build(sys_, b, ranked=ranked, device="cpu")
    _assert_same_solve_layout(ref, port)
    assert port.kernel == ("ranked" if ranked else "blocks")
    _assert_same_solve_layout(ref, tsolve.lower_solve_layout_from_jax(ref, device="cpu"))


def test_binned_choice_matches_reference():
    """The exact rank windows exceed RANKED_SOLVE_MAX_NB, so both packages
    weigh the binned widths by the same cost and keep the same one."""
    sys_ = thost.build_sts(_binned(), order_type="LS")
    b = thost.compute_b(sys_.lower)
    port = tsolve.LowerSolveLayout.build(sys_, b, device="cpu")
    ref = jsolve.LowerSolveLayout.build(sys_, b)
    _assert_same_solve_layout(ref, port)
    assert port.ranked is not None
    assert port.ranked.rank_nb <= tsolve.RANKED_SOLVE_MAX_NB
    # The exact (unbinned) windows of the same system are too wide.
    assert port.slabs.max_nb > tsolve.RANKED_SOLVE_MAX_NB


@pytest.mark.parametrize("table", ["empty", "v5e", "h100"])
def test_subtile_cost_matches_reference(table, monkeypatch, tmp_path):
    """The cost that weighs the solve's bin widths is tune/model's, read
    through the calibration lookup as the reference's is."""
    from test_torch_plan import TABLES, pin_calibration
    from tpu_spmv.tune.model import _ranked_subtile_cost
    from tpu_spmv_torch.tune.model import _ranked_subtile_cost as ours

    pin_calibration(monkeypatch, tmp_path, TABLES[table])
    for nb in range(1, 17):
        assert ours(nb) == _ranked_subtile_cost(nb)
    assert tsolve.RANKED_SOLVE_MAX_NB == jsolve.RANKED_SOLVE_MAX_NB


@pytest.mark.parametrize("table,width", [("v5e", 2), ("empty", 4)])
def test_binned_width_follows_the_calibration(table, width, monkeypatch,
                                              tmp_path):
    """A level-scheduled band whose binned widths cost W = 2: 320
    sub-tiles of rank 2, W = 4 and 8: 256 of rank 4 and 8. The module
    defaults (3.3 + 0.95 a pair) pick W = 4, the reference's shipped v5e
    constants (5.404 + 2.591 a pair) pick W = 2; both packages pick the
    same W and the same arrays under either, where the port once weighed
    with the defaults alone."""
    from test_torch_plan import TABLES, pin_calibration

    pin_calibration(monkeypatch, tmp_path, TABLES[table])
    sys_ = thost.build_sts(random_banded(1536, 60, 6, seed=0),
                           order_type="LS")
    b = thost.compute_b(sys_.lower)
    port = tsolve.LowerSolveLayout.build(sys_, b, device="cpu")
    ref = jsolve.LowerSolveLayout.build(sys_, b)
    _assert_same_solve_layout(ref, port)
    assert port.slabs.max_nb > tsolve.RANKED_SOLVE_MAX_NB
    assert port.ranked.rank_nb == width


_SOLVES = {
    "lap2d_LS": ("lap2d", dict(order_type="LS")),
    "banded_COLOR": ("banded", dict(order_type="COLOR")),
    "general_LS": ("general", dict(order_type="LS")),
    "banded_LS_k3": ("banded", dict(order_type="LS", k=3, sup_row_sizes=(8,))),
}


@pytest.mark.parametrize("ranked", [True, False], ids=["ranked", "blocks"])
@pytest.mark.parametrize("case", sorted(_SOLVES))
def test_plain_solve_matches_pallas_and_oracle(case, ranked):
    name, kw = _SOLVES[case]
    sys_ = thost.build_sts(MATS[name](), **kw)
    b = thost.compute_b(sys_.lower)
    port = tsolve.LowerSolveLayout.build(sys_, b, ranked=ranked, device="cpu")
    assert port.kernel == ("ranked" if ranked else "blocks")
    x = tsolve.lower_solve(port).numpy()
    x_ref = tsolve.lower_solve_reference(sys_, b)
    ref = jsolve.LowerSolveLayout.build(sys_, b, ranked=ranked)
    x_jax = np.asarray(jsolve.lower_solve(ref, interpret=True))
    assert _rel(x, x_ref) <= 1e-5
    assert _rel(x, x_jax) <= 1e-5
    assert int(np.sum(np.abs(x - 1.0) > 0.01)) == 0
    # The JAX layout carried across solves to the same x.
    x_conv = tsolve.lower_solve(
        tsolve.lower_solve_layout_from_jax(ref, sys_, device="cpu")
    ).numpy()
    assert _rel(x_conv, x) <= 1e-6


def test_binned_plain_solve_matches_oracle():
    """The column-binned ranked layout (JAX: 0.7 ms interpret-free on a
    v5e; here the plain version) against the oracle, random rhs."""
    sys_ = thost.build_sts(_binned(), order_type="LS")
    b = np.random.default_rng(0).standard_normal(sys_.lower.m).astype(
        np.float32)
    lay = tsolve.LowerSolveLayout.build(sys_, b, device="cpu")
    assert lay.kernel == "ranked"
    x = tsolve.lower_solve(lay).numpy()
    x_ref = tsolve.lower_solve_reference(sys_, b)
    assert _rel(x, x_ref) <= 1e-5
    blocks = tsolve.LowerSolveLayout.build(sys_, b, ranked=False, device="cpu")
    assert _rel(tsolve.lower_solve(blocks).numpy(), x_ref) <= 1e-5


def test_steps_by_pack_and_by_chunk_agree():
    """The plain versions give the same x stepping pack by pack (the
    layout's schedule) or chunk by chunk (no schedule)."""
    sys_ = thost.build_sts(MATS["banded"](), order_type="LS")
    lay = tsolve.LowerSolveLayout.build(sys_, thost.compute_b(sys_.lower), device="cpu")
    assert lay.num_packs == sys_.num_packs
    steps = lay.ranked_steps
    assert steps.shape == (sys_.num_packs + 1, 2)
    assert np.array_equal(steps[:, 1], lay.ranked.chunk_ptr.numpy()[steps[:, 0]])
    by_pack = lower_solve_ranked_reference(lay.ranked, lay.b_scale, steps)
    by_chunk = lower_solve_ranked_reference(lay.ranked, lay.b_scale)
    assert torch.equal(by_pack, by_chunk)
    assert by_pack.shape == (lay.ranked.num_chunks + 1 + lay.ranked.rank_nb, 128)
    blk = lower_solve_blocks_reference(lay.slabs, lay.b_scale, lay.slab_steps)
    assert torch.equal(
        blk, lower_solve_blocks_reference(lay.slabs, lay.b_scale,
                                          solve_steps(lay.slabs.chunk_ptr)))
    assert blk.shape == (lay.slabs.num_chunks + 1, 128)
    # On a CPU tensor the wrappers are the plain versions.
    assert torch.equal(lower_solve_ranked(lay.ranked, lay.b_scale, steps),
                       by_pack)
    assert torch.equal(lower_solve_blocks(lay.slabs, lay.b_scale), blk)


def test_padding_only_first_chunk():
    """Pack 0 holds the level-0 rows, which have no strict-L entries: its
    chunk is all padding, and its padding slots point at chunk 0 itself
    (the self-wait hazard of a flag-waiting kernel). A diagonal-only
    matrix makes every chunk so."""
    sys_ = thost.build_sts(MATS["lap2d"](), order_type="LS")
    lay = tsolve.LowerSolveLayout.build(sys_, thost.compute_b(sys_.lower),
                                        ranked=False, device="cpu")
    k = lay.slabs.chunk_ptr.numpy()
    first = slice(k[0] * 8, k[1] * 8)
    assert not lay.slabs.vals.numpy()[first].any()
    assert not lay.slabs.cols.numpy()[first].any()  # all at block 0
    x = tsolve.lower_solve(lay).numpy()
    assert int(np.sum(np.abs(x - 1.0) > 0.01)) == 0

    n = 300
    diag = CSRMatrix.from_coo(np.arange(n), np.arange(n),
                              np.linspace(1, 4, n).astype(np.float32), (n, n))
    dsys = thost.build_sts(diag, order_type="LS")
    assert dsys.num_packs == 1
    b = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    for ranked in (True, False):
        dl = tsolve.LowerSolveLayout.build(dsys, b, ranked=ranked, device="cpu")
        x = tsolve.lower_solve(dl).numpy()
        assert _rel(x, b / diag.data[dsys.perm]) <= 1e-6


def test_upper_solve_scipy_parity():
    """Backward substitution through reversed_for_upper equals scipy's
    upper solve on the original triangle (arbitrary rhs), as
    tests/test_sts.py::test_upper_solve_scipy_parity holds the JAX
    package to (a triangular input, LS order, sort_packs=False)."""
    full = random_banded(700, 40, 8, seed=11)
    U = sp.triu(full.to_scipy(), format="csr")
    mat = CSRMatrix.from_scipy(U)
    b = np.random.default_rng(0).standard_normal(mat.m).astype(np.float32)
    x_ref = spsolve_triangular(U.astype(np.float64), b.astype(np.float64),
                               lower=False)
    mat_r, rev = thost.reversed_for_upper(mat)
    sys_ = thost.build_sts(mat_r, order_type="LS", sort_packs=False)
    assert sys_.lower.nnz == mat.nnz
    for ranked in (True, False):
        lay = tsolve.LowerSolveLayout.build(sys_, b[rev][sys_.perm],
                                            ranked=ranked, device="cpu")
        x_r = np.zeros(mat.m, np.float32)
        x_r[sys_.perm] = tsolve.lower_solve(lay).numpy()
        assert _rel(x_r[rev], x_ref) <= 1e-5


def test_layout_moves_with_its_nested_slabs():
    sys_ = thost.build_sts(MATS["banded"](), order_type="LS")
    lay = tsolve.LowerSolveLayout.build(sys_, thost.compute_b(sys_.lower), device="cpu")
    copy = lay.clone()
    assert copy.ranked.vals.data_ptr() != lay.ranked.vals.data_ptr()
    assert copy.slabs.cols.data_ptr() != lay.slabs.cols.data_ptr()
    assert copy.slab_steps is lay.slab_steps
    assert lay.nbytes == (lay.slabs.nbytes + lay.ranked.nbytes + sum(
        t.numel() * t.element_size() for t in lay.tensors().values()))
    assert dataclasses.replace(lay, ranked=None).kernel == "blocks"


@pytest.mark.parametrize("args", [
    [],
    ["--order", "COLOR"],
    ["--k", "3"],
    ["--part", "upper"],
])
def test_sts_cli_validates_on_cpu(args, capsys):
    from tpu_spmv_torch.tools import sts

    rc = sts.main(["synthetic:banded_1k", *args, "--device", "cpu",
                   "--validate-only"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Number Wrong: 0" in out and "Total Error:" in out
    assert "packs:" in out and "solve kernel:" in out
    if "upper" in args:
        assert "backward substitution" in out


def test_sts_cli_refusals(monkeypatch):
    from tpu_spmv_torch.tools import sts

    with pytest.raises(SystemExit, match="timing needs a CUDA card"):
        sts.main(["synthetic:banded_1k", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        sts.main(["synthetic:banded_1k", "--validate-only"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        sts.main(["synthetic:banded_1k", "--devices", "2"])


def _solve_table(ranked_round: float, blocks_round: float) -> dict:
    """A card's solve constants: a link of 1 and the given cost a round."""
    return {"unit_ns": 1.0, "solve_ranked_link": 1.0,
            "solve_ranked_round": ranked_round, "solve_blocks_link": 1.0,
            "solve_blocks_round": blocks_round}


@pytest.mark.parametrize("case", sorted(_SOLVES))
def test_calibrated_blocks_choice_matches_pallas(case, monkeypatch, tmp_path):
    """Under a table where the blocks solve costs less, the layout keeps
    the reference's arrays (the ranked layout too), reports blocks, and
    lower_solve runs the blocks solve, within RelL2 1e-5 of the
    reference's Pallas solve (interpret mode) on its own layout."""
    from test_torch_plan import pin_calibration

    pin_calibration(monkeypatch, tmp_path, _solve_table(10.0, 0.1))
    name, kw = _SOLVES[case]
    sys_ = thost.build_sts(MATS[name](), **kw)
    b = thost.compute_b(sys_.lower)
    port = tsolve.LowerSolveLayout.build(sys_, b, device="cpu")
    ref = jsolve.LowerSolveLayout.build(sys_, b)
    _assert_same_solve_layout(ref, port)
    assert port.ranked is not None and port.kernel == "blocks"

    def refused(*args, **kw):
        raise AssertionError("the ranked solve ran")

    monkeypatch.setattr(tsolve, "lower_solve_ranked", refused)
    x = tsolve.lower_solve(port).numpy()
    x_jax = np.asarray(jsolve.lower_solve(ref, interpret=True))
    assert _rel(x, x_jax) <= 1e-5
    assert _rel(x, tsolve.lower_solve_reference(sys_, b)) <= 1e-5


def test_calibrated_choice_follows_the_costs(monkeypatch, tmp_path):
    """The cheaper chain wins: ranked under a table that favours it,
    blocks under one that favours blocks, the reference's ranked with no
    solve constants (or an entry that lacks one of them)."""
    from test_torch_plan import pin_calibration

    sys_ = thost.build_sts(_binned(), order_type="LS")
    b = thost.compute_b(sys_.lower)
    for entry, kernel in ((_solve_table(0.1, 10.0), "ranked"),
                          (_solve_table(10.0, 0.1), "blocks"),
                          ({}, "ranked"),
                          ({"solve_blocks_link": 0.0}, "ranked")):
        pin_calibration(monkeypatch, tmp_path, entry)
        lay = tsolve.LowerSolveLayout.build(sys_, b, device="cpu")
        assert lay.kernel == kernel, entry
        assert tsolve.lower_solve_layout_from_jax(
            jsolve.LowerSolveLayout.build(sys_, b), device="cpu"
        ).kernel == "ranked"


def test_solve_cost_walks_the_longest_chain():
    """solve_cost on a chain of chunks (tools/tune.chain_system): each
    chunk waits on the one before, so the cost is every chunk's link
    plus its rounds of SOLVE_GROUP sub-tiles; on two independent packs
    it is the longer one's."""
    from tpu_spmv_torch.tools.tune import chain_system

    sys_ = chain_system(6, 4)
    lay = tsolve.LowerSolveLayout.build(sys_, np.ones(sys_.lower.m),
                                        device="cpu")
    sub = np.diff(lay.slabs.chunk_ptr.numpy())
    assert sub.tolist() == [1] + [4] * 5  # the first chunk: padding only
    assert tsolve.solve_cost(lay.slabs, 1.0, 0.0) == 6.0
    assert tsolve.solve_cost(lay.slabs, 0.0, 1.0) == 1 + 5 * 2
    assert tsolve.solve_cost(lay.slabs, 2.0, 0.5) == 12.0 + 5.5
    x = tsolve.lower_solve(lay).numpy()
    assert _rel(x, tsolve.lower_solve_reference(sys_, np.ones(sys_.lower.m))
                ) <= 1e-5
    flat = thost.build_sts(MATS["lap2d"](), order_type="COLOR")
    lay = tsolve.LowerSolveLayout.build(flat, thost.compute_b(flat.lower),
                                        device="cpu")
    assert tsolve.solve_cost(lay.slabs, 1.0, 0.0) == 2.0


def test_solve_group_is_the_kernels():
    """SOLVE_GROUP, the rounds solve_cost counts, is csrc/sts.cu's kGroup."""
    import pathlib
    import re

    src = (pathlib.Path(tsolve.__file__).parent.parent / "kernels" / "csrc"
           / "sts.cu").read_text()
    assert int(re.search(r"constexpr int kGroup = (\d+);", src).group(1)) \
        == tsolve.SOLVE_GROUP
