"""The layout cache (formats/sell.save_layout, load_layout and the CLI's
--layout-cache) against the JAX package's.

A cache is the reference's .npz: __class__, __aux__, the arrays c{i} in
the order of the reference's tree_flatten, bf16 arrays as uint16 bits
listed in __bf16__, and the matrix fingerprint __mkey__. So a cache
written by either package loads in the other: the port's load equals
formats.convert.from_reference of the reference's layout, and the
reference's load of a port-written cache equals its own build, array
for array. A cache of another matrix or configuration raises
LayoutCacheMismatch; the CLI's second run loads the cache and validates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_spmv.bench.matrices import make as jmake
from tpu_spmv.formats import packed as jpacked
from tpu_spmv.formats import sell as jsell

from tpu_spmv_torch.bench.harness import validate
from tpu_spmv_torch.bench.matrices import make
from tpu_spmv_torch.formats import packed as tpacked
from tpu_spmv_torch.formats import sell as tsell
from tpu_spmv_torch.formats.convert import from_reference
from tpu_spmv_torch.kernels.packed import spmv_packed
from tpu_spmv_torch.kernels.sell import spmv_ranked, spmv_sell
from tpu_spmv_torch.tools import spmv as cli

from test_torch_formats import assert_same_layout

CPU = ["--device", "cpu", "--validate-only"]
LAYOUTS = {
    "sell": (jsell.SellSlabs, tsell.SellSlabs, spmv_sell),
    "ranked": (jsell.RankedSlabs, tsell.RankedSlabs, spmv_ranked),
    "packed": (jpacked.PackedRanked, tpacked.PackedRanked, spmv_packed),
}
CASES = [("sell", "f32", 0), ("ranked", "f32", 0), ("ranked", "bf16", 0),
         ("ranked", "f32", 2), ("packed", "f32", 0), ("packed", "bf16", 0),
         ("packed", "f32", 2)]
CONFIG = (0, -1, 1)


def _build(kind, dtype, w, mat, port: bool):
    jcls, tcls, _ = LAYOUTS[kind]
    kw = {} if not w else {"bin_blocks": w}
    if dtype == "bf16":
        kw["val_dtype"] = torch.bfloat16 if port else jnp.bfloat16
    return (tcls if port else jcls).from_csr(mat, **kw)


def _assert_same_tensors(a, b):
    assert type(a) is type(b)
    ta, tb = a.tensors(), b.tensors()
    assert ta.keys() == tb.keys()
    for k in ta:
        assert ta[k].dtype == tb[k].dtype and torch.equal(ta[k], tb[k]), k


@pytest.mark.parametrize("kind,dtype,w", CASES)
def test_round_trip_in_the_port(kind, dtype, w, tmp_path):
    mat = make("banded_1k")
    built = _build(kind, dtype, w, mat, port=True)
    path = tmp_path / "lay.npz"
    built.save(path, matrix=mat, config=CONFIG)
    loaded = tsell.load_layout(path, matrix=mat, config=CONFIG)
    _assert_same_tensors(built, loaded)
    fn = LAYOUTS[kind][2]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        mat.n).astype(np.float32))
    assert torch.equal(fn(built, x), fn(loaded, x))


@pytest.mark.parametrize("kind,dtype,w", CASES)
def test_reference_cache_loads_in_the_port(kind, dtype, w, tmp_path):
    jmat = jmake("banded_1k")
    ref = _build(kind, dtype, w, jmat, port=False)
    path = tmp_path / "ref.npz"
    ref.save(path, matrix=jmat, config=CONFIG)
    loaded = tsell.load_layout(path, matrix=make("banded_1k"), config=CONFIG)
    _assert_same_tensors(from_reference(ref), loaded)
    assert_same_layout(ref, loaded)


@pytest.mark.parametrize("kind,dtype,w", CASES)
def test_port_cache_loads_in_the_reference(kind, dtype, w, tmp_path):
    mat = make("banded_1k")
    path = tmp_path / "port.npz"
    _build(kind, dtype, w, mat, port=True).save(path, matrix=mat,
                                               config=CONFIG)
    jmat = jmake("banded_1k")
    loaded = jsell.load_layout(path, matrix=jmat, config=CONFIG)
    ref = _build(kind, dtype, w, jmat, port=False)
    assert type(loaded) is type(ref)
    a, b = jax.tree_util.tree_flatten(loaded), jax.tree_util.tree_flatten(ref)
    assert a[1] == b[1]  # the static fields
    for x, y in zip(a[0], b[0]):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_cache_files_hold_the_same_arrays(tmp_path):
    """The two packages write the same keys, dtypes and values."""
    mat, jmat = make("general_1k"), jmake("general_1k")
    for kind, dtype, w in CASES:
        a, b = tmp_path / "a.npz", tmp_path / "b.npz"
        _build(kind, dtype, w, mat, port=True).save(a, matrix=mat,
                                                    config=CONFIG)
        _build(kind, dtype, w, jmat, port=False).save(b, matrix=jmat,
                                                      config=CONFIG)
        with np.load(a) as za, np.load(b) as zb:
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                assert za[k].dtype == zb[k].dtype, (kind, k)
                assert np.array_equal(za[k], zb[k]), (kind, k)


def test_matrix_key_matches_reference():
    mat, jmat = make("banded_1k"), jmake("banded_1k")
    for cfg in ((), (0, -1, 1), (2, 4096, 1, 1)):
        assert np.array_equal(tsell.matrix_key(mat, cfg),
                              jsell.matrix_key(jmat, cfg))


def test_mismatch_raises(tmp_path):
    mat = make("banded_1k")
    path = tmp_path / "lay.npz"
    tsell.RankedSlabs.from_csr(mat).save(path, matrix=mat, config=CONFIG)
    with pytest.raises(tsell.LayoutCacheMismatch, match="rebuild it"):
        tsell.load_layout(path, matrix=make("general_1k"), config=CONFIG)
    with pytest.raises(tsell.LayoutCacheMismatch, match="rebuild it"):
        tsell.load_layout(path, matrix=mat, config=(2, -1, 1))
    # Without a matrix no fingerprint is checked.
    assert isinstance(tsell.load_layout(path), tsell.RankedSlabs)


def test_cli_second_run_loads_the_cache(tmp_path, capsys):
    path = str(tmp_path / "lay.npz")
    argv = ["synthetic:banded_1k", "--kernel", "ranked", "--layout-cache",
            path, *CPU]
    assert cli.main(argv) == 0
    first = capsys.readouterr().out
    assert "saved layout to" in first and "Number Wrong: 0 " in first
    assert cli.main(argv) == 0
    second = capsys.readouterr().out
    assert "loaded layout from" in second and "Number Wrong: 0 " in second
    assert first.split("RelL2:")[1] == second.split("RelL2:")[1]
    # Another configuration: the stale cache is refused, not benchmarked.
    with pytest.raises(SystemExit, match="rebuild it"):
        cli.main([*argv, "--val-dtype", "bf16"])
    with pytest.raises(SystemExit, match="kernel wants SellSlabs"):
        cli.main(["synthetic:banded_1k", "--kernel", "sell",
                  "--layout-cache", path, *CPU])


def test_cli_reuses_a_packed_runs_ranked_fallback(tmp_path, capsys):
    """A packed build past the packed-delta range falls back to ranked and
    caches the ranked layout; the next packed run takes it (the reference
    refuses it as the wrong class)."""
    path = str(tmp_path / "lay.npz")
    argv = ["synthetic:powerlaw_100k", "--kernel", "packed", "--bin-blocks",
            "8", "--sigma", "0", "--layout-cache", path, *CPU]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "falling back to ranked" in out and "saved layout" in out
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "holds the ranked fallback" in out and "loaded layout" in out
    assert "Number Wrong: 0 " in out


@pytest.mark.parametrize("sigma,expect", [
    ("-1", "planner recommends sigma=4096"),
    ("4096", "sigma=4096 row sort applied"),
    ("0", ""),
])
def test_cli_sigma(sigma, expect, capsys):
    """The planner's sigma (re-planned on the sorted matrix, kept when it
    costs less), a forced sigma, and none: each validates through the
    row permutation."""
    assert cli.main(["synthetic:powerlaw_100k", "--sigma", sigma, *CPU]) == 0
    out = capsys.readouterr().out
    assert expect in out and "Number Wrong: 0 " in out
    if sigma == "0":
        assert "sigma=" not in out


def test_cli_rejects_a_recommended_sort_that_costs_more(monkeypatch, capsys):
    """A recommended sort whose re-plan costs more is rejected with the
    reference's message; the forced one is applied regardless."""
    from tpu_spmv_torch.tune import model

    real = model.tpu_plan
    calls = []

    def plan(mat, *a, **kw):
        p = real(mat, *a, **kw)
        calls.append(p)
        if len(calls) > 1:  # the re-plan on the sorted matrix
            p.est_cost = calls[0].est_cost + 1
        return p

    monkeypatch.setattr(model, "tpu_plan", plan)
    assert cli.main(["synthetic:powerlaw_100k", "--rcm", "never",
                     *CPU]) == 0
    out = capsys.readouterr().out
    assert "rejected after re-plan" in out and "Number Wrong: 0 " in out


def test_cli_y_follows_the_row_sort(capsys):
    """With a sort applied, y comes out in the sorted row order and the
    oracle is gathered with the same permutation (Number Wrong 0 at the
    full suite tolerance)."""
    mat = make("powerlaw_100k")
    ck, perm = cli.prepare(mat, "auto")
    sorted_mat, sperm = tsell.sigma_sort(ck.matrix, 4096)
    lay, fn, _ = cli.build_layout(sorted_mat, "ranked", device="cpu")
    x = np.random.default_rng(0).standard_normal(mat.n).astype(np.float32)
    y = fn(lay, torch.from_numpy(x[perm])).numpy()
    wrong, rel = validate(y, mat.matvec(x)[perm[sperm]])
    assert wrong == 0 and rel <= 1e-6
