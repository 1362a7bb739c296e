"""The port's planner (tune/model.py), its calibration lookup (hw.py) and
its calibration tool (tools/tune.py) against the JAX package's.

tpu_plan reads measured cost constants through each package's
calibration lookup, so every comparison pins both packages to the same
table: the reference through $TPU_SPMV_CALIB (an entry keyed "v5e", the
kind it gives a CPU), the port through $TPU_SPMV_TORCH_CALIB (keyed
"cpu", the port's kind without a card). Three tables: empty (the
module defaults), the reference's shipped v5e entry, and an H100-like
entry. Equal means the same kernel, bin width, sigma, needs_rcm and
tile_k, and est_max_nb, est_rank_nb and est_cost to a relative 1e-9.
The matrices are the shapes of tests/test_tools.py's and
tests/test_config_and_baselines.py's planner tests and the tiny and
small suites; x passes both packages' residency gates on all of them.
"""

import functools
import json
import pathlib

import numpy as np
import pytest

from tpu_spmv.bench import matrices as jmat
from tpu_spmv.formats import sell as jsell
from tpu_spmv.formats.csr import CSRMatrix as JCSR
from tpu_spmv.tools import tune as jtune
from tpu_spmv.tune import model as jmodel

from tpu_spmv_torch import hw
from tpu_spmv_torch.formats import sell as tsell
from tpu_spmv_torch.formats.csr import CSRMatrix
from tpu_spmv_torch.tools import tune as ttune
from tpu_spmv_torch.tune import model as tmodel

REPO = pathlib.Path(__file__).resolve().parent.parent
V5E = json.loads((REPO / "tpu_spmv" / "data" / "calib.json").read_text())["v5e"]
TABLES = {
    "empty": {},
    "v5e": V5E,
    "h100": {"ranked_fixed": 12.0, "pair_cost": 0.05, "ranked_iter_cost": 1.0,
             "packed_over": 1.5, "epi_cost": 0.4},
}


def pin_calibration(monkeypatch, tmp_path, entry: dict) -> None:
    """Both packages read `entry` as the current device's constants."""
    ref, port = tmp_path / "ref_calib.json", tmp_path / "port_calib.json"
    ref.write_text(json.dumps({"v5e": entry}))
    port.write_text(json.dumps({"cpu": entry}))
    monkeypatch.setenv("TPU_SPMV_CALIB", str(ref))
    monkeypatch.setenv(hw.CALIB_ENV, str(port))


def _jittered():
    """tests/test_config_and_baselines.py's wide stencil with each
    offset jittered: hundreds of diagonals, clustered ranks."""
    full = jmat.laplacian_2d(8, 2048)
    rng = np.random.default_rng(7)
    rows = np.repeat(np.arange(full.m, dtype=np.int64), full.row_lengths)
    cols = np.clip(full.indices.astype(np.int64)
                   + rng.integers(-8, 9, full.nnz), 0, full.n - 1)
    return JCSR.from_coo(rows, cols, np.ones(full.nnz, np.float32), full.shape)


def _skewed():
    """tests/test_config_and_baselines.py's power-law row lengths, which
    earn a sigma recommendation."""
    rng = np.random.default_rng(0)
    m = 20_000
    lens = np.minimum((rng.pareto(1.2, m) * 3 + 1).astype(np.int64), 400)
    rows = np.repeat(np.arange(m), lens)
    cols = np.minimum(rows + rng.integers(0, 200, rows.shape[0]), m - 1)
    return JCSR.from_coo(rows, cols, np.ones(rows.shape[0], np.float32),
                         (m, m))


SHAPES = {
    "tools_banded_2000": lambda: jmat.random_banded(2000, 40, 8, seed=1),
    "tools_general_50k": lambda: jmat.random_general(50_000, 8, seed=2),
    "lap2d_16": lambda: jmat.laplacian_2d(16),
    "stencil_8x2048": lambda: jmat.laplacian_2d(8, 2048),
    "jittered_8x2048": _jittered,
    "wide_random_300k": lambda: jmat.random_banded(300_000, 1500, 8, seed=1),
    "scattered_300k": lambda: jmat.random_general(300_000, 8, seed=2),
    "lap2d_64": lambda: jmat.laplacian_2d(64),
    "skewed_20k": _skewed,
    **{name: functools.partial(jmat.make, name)
       for scale in ("tiny", "small") for name in jmat.suite_factories(scale)},
}


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(reference CSRMatrix, the port's CSRMatrix of the same arrays)."""
    ref = SHAPES[name]()
    return ref, CSRMatrix(ref.indptr, ref.indices, ref.data, ref.shape)


def assert_same_plan(ref, port):
    for f in ("kernel", "bin_blocks", "sigma", "needs_rcm", "tile_k"):
        assert getattr(ref, f) == getattr(port, f), (f, ref, port)
    for f in ("est_max_nb", "est_rank_nb", "est_cost"):
        a, b = getattr(ref, f), getattr(port, f)
        assert abs(a - b) <= 1e-9 * max(abs(a), 1.0), (f, a, b)


@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plan_matches_reference(name, table, monkeypatch, tmp_path):
    pin_calibration(monkeypatch, tmp_path, TABLES[table])
    ref, port = _pair(name)
    assert tmodel._cal("ranked_fixed", -1.0) == jmodel._cal(
        "ranked_fixed", -1.0)
    assume = name not in ("tools_banded_2000", "lap2d_16")
    assert_same_plan(jmodel.tpu_plan(ref, assume_rcm=assume),
                     tmodel.tpu_plan(port, assume_rcm=assume))


def test_plan_estimate_only_path_matches_reference(monkeypatch, tmp_path):
    pin_calibration(monkeypatch, tmp_path, V5E)
    for name in ("tools_general_50k", "lap2d_64", "skewed_20k"):
        ref, port = _pair(name)
        assert_same_plan(jmodel.tpu_plan(ref, exact=False),
                         tmodel.tpu_plan(port, exact=False))


def test_plan_picks_what_the_reference_tests_expect(monkeypatch, tmp_path):
    """The planner classes of tests/test_tools.py and
    tests/test_config_and_baselines.py, on the port."""
    pin_calibration(monkeypatch, tmp_path, {})
    plan = lambda n, **kw: tmodel.tpu_plan(_pair(n)[1], **kw)  # noqa: E731
    assert plan("stencil_8x2048", assume_rcm=True).kernel == "dia"
    p = plan("jittered_8x2048", assume_rcm=True)
    assert p.kernel in ("ranked", "packed") and p.bin_blocks == 0
    for n in ("tools_general_50k", "wide_random_300k", "scattered_300k"):
        p = plan(n, assume_rcm=True)
        assert p.kernel in ("ranked", "packed") and p.bin_blocks > 0, p
    assert plan("lap2d_64", assume_rcm=True).sigma == 0
    assert plan("skewed_20k", assume_rcm=True).sigma > 0
    lap = plan("lap2d_32")
    assert lap.kernel == "dia" and not lap.needs_rcm and lap.sigma == 0
    # needs_rcm from the exact chunk span: general_1k's is 8.0 blocks,
    # at the threshold, so it stays in order; general_50k's is wider.
    assert plan("general_1k").est_max_nb == 8.0
    assert not plan("general_1k").needs_rcm
    assert plan("general_50k").needs_rcm
    assert not plan("general_50k", assume_rcm=True).needs_rcm


def test_packed_drops_out_past_the_port_gate(monkeypatch, tmp_path):
    """The port charges x against half the L2 (kernels/sell.
    resident_x_fits), not the reference's VMEM: with no L2 at all, the
    packed candidates are not offered, where the reference still
    offers them."""
    pin_calibration(monkeypatch, tmp_path, {"packed_over": 0.1})
    ref, port = _pair("lap2d_64")
    from tpu_spmv_torch.reorder import rcm

    perm = rcm(port.indptr, port.indices)
    port = port.permuted(perm)
    ref = ref.permuted(perm)
    assert tmodel.tpu_plan(port, assume_rcm=True).kernel == "packed"
    monkeypatch.setattr(hw, "H100_L2_BYTES", 0)
    assert not tmodel._packed_x_fits(port, 2)
    assert tmodel.tpu_plan(port, assume_rcm=True).kernel != "packed"
    assert jmodel.tpu_plan(ref, assume_rcm=True).kernel == "packed"


@pytest.mark.parametrize("arch", ["ampere", "volta", "mi100", "legacy"])
def test_reference_gpu_params_match(arch):
    for d in np.geomspace(0.3, 300.0, 61):
        assert tmodel.reference_gpu_params(d, arch) == \
            jmodel.reference_gpu_params(d, arch), (arch, d)
    with pytest.raises(ValueError):
        tmodel.reference_gpu_params(5.0, "nope")


@pytest.mark.parametrize("name", ["banded_1k", "general_1k", "lap2d_64",
                                  "skewed_20k"])
def test_exact_rank_nb_sampling_and_subtiles_match(name, monkeypatch,
                                                  tmp_path):
    pin_calibration(monkeypatch, tmp_path, V5E)
    ref, port = _pair(name)
    for align in (True, False):
        assert tmodel.exact_rank_nb(port, align=align) == \
            jmodel.exact_rank_nb(ref, align=align)
    assert tmodel._exact_chunk_nb(port) == jmodel._exact_chunk_nb(ref)
    for cap in (256, 4):
        ours, scale = tmodel._sample_chunks(port, cap)
        theirs, ref_scale = jmodel._sample_chunks(ref, cap)
        assert scale == ref_scale and ours.shape == theirs.shape
        for f in ("indptr", "indices", "data"):
            assert np.array_equal(getattr(ours, f), getattr(theirs, f))
    kc = tsell._aligned_slots(port)[1]
    assert tmodel._subtiles_from_kc(kc) == jmodel._subtiles_from_kc(kc)
    assert tmodel._epi_cost(kc) == jmodel._epi_cost(kc)
    from tpu_spmv.formats.dia import diagonal_profile as jprofile
    from tpu_spmv_torch.formats.dia import diagonal_profile

    for rows in (0, 256):
        assert diagonal_profile(port, rows) == jprofile(ref, rows)


@pytest.mark.parametrize("sigma", [128, 4096])
@pytest.mark.parametrize("name", ["banded_1k", "skewed_20k", "general_1k"])
def test_sigma_sort_and_shape_stats_match(name, sigma):
    ref, port = _pair(name)
    (a, pa), (b, pb) = tsell.sigma_sort(port, sigma), jsell.sigma_sort(ref, sigma)
    assert np.array_equal(pa, pb)
    for f in ("indptr", "indices", "data"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    for w in (0, 16):
        assert tsell.SellSlabs.shape_stats(port, bin_blocks=w) == \
            jsell.SellSlabs.shape_stats(ref, bin_blocks=w)


def test_fit_affine_matches_reference():
    pts = [(1, 4.25), (2, 5.2), (4, 7.1)]
    a, b = ttune.fit_affine(pts)
    assert (a, b) == jtune.fit_affine(pts)
    assert abs(a - 3.3) < 1e-6 and abs(b - 0.95) < 1e-6
    with pytest.raises(ValueError):
        ttune.fit_affine([(1, 2.0)])


def test_calibration_env_variable_is_read_alone(monkeypatch, tmp_path):
    user = tmp_path / "user.json"
    user.write_text(json.dumps({"cpu": {"ranked_fixed": 1.0}}))
    monkeypatch.setattr(hw, "USER_CALIB", str(user))
    monkeypatch.delenv(hw.CALIB_ENV, raising=False)
    assert hw.kernel_calibration() == {"ranked_fixed": 1.0}
    env = tmp_path / "env.json"
    env.write_text(json.dumps({"cpu": {"ranked_fixed": 10.0,
                                       "pair_cost": 2.0}}))
    monkeypatch.setenv(hw.CALIB_ENV, str(env))
    assert hw.calib_paths() == [str(env)]
    assert hw.kernel_calibration() == {"ranked_fixed": 10.0,
                                       "pair_cost": 2.0}
    assert tmodel._ranked_subtile_cost(4) == 14.0
    # Set but missing: the defaults, not the user cache.
    monkeypatch.setenv(hw.CALIB_ENV, str(tmp_path / "missing.json"))
    assert hw.kernel_calibration() == {}
    assert tmodel._ranked_subtile_cost(4) == 3.3 + 0.95 * 2


def test_calibration_for_another_card_does_not_hide_the_shipped(
        monkeypatch, tmp_path):
    user = tmp_path / "user.json"
    user.write_text(json.dumps({"another card": {"ranked_fixed": 1.0}}))
    shipped = tmp_path / "shipped.json"
    shipped.write_text(json.dumps({"cpu": {"ranked_fixed": 7.5}}))
    monkeypatch.delenv(hw.CALIB_ENV, raising=False)
    monkeypatch.setattr(hw, "USER_CALIB", str(user))
    monkeypatch.setattr(hw, "SHIPPED_CALIB", str(shipped))
    assert hw.kernel_calibration() == {"ranked_fixed": 7.5}
    monkeypatch.setattr(hw, "device_kind", lambda: "another card")
    assert hw.kernel_calibration() == {"ranked_fixed": 1.0}
    monkeypatch.setattr(hw, "device_kind", lambda: "a third card")
    assert hw.kernel_calibration() == {}


def test_shipped_table_is_keyed_by_card_name():
    table = json.loads(pathlib.Path(hw.SHIPPED_CALIB).read_text())
    keys = set(ttune.KEYS)
    for kind, entry in table.items():
        assert kind != "cpu" and "H100" in kind, kind
        assert set(entry) == keys and all(
            isinstance(v, float) for v in entry.values()), entry


def test_measure_runs_on_the_cpu(monkeypatch, tmp_path, capsys):
    consts = ttune.measure(scale=0.02, device="cpu")
    assert tuple(consts) == ttune.KEYS
    assert all(v >= 0.0 for v in consts.values()), consts
    assert consts["unit_ns"] > 0 and consts["span_limit"] >= min(ttune.SPANS)
    err = capsys.readouterr().err
    for key in ("# span ", "# W=8:", "# packed:", "# epi:", "# dia:",
                "# read rate:", "# chain of "):
        assert key in err
    # The CLI writes the CPU's numbers only to a file it is given.
    monkeypatch.delenv(hw.CALIB_ENV, raising=False)
    monkeypatch.setattr(hw, "USER_CALIB", str(tmp_path / "user.json"))
    assert ttune.main(["--calibrate", "--device", "cpu", "--scale",
                       "0.02"]) == 0
    assert not (tmp_path / "user.json").exists()
    out = tmp_path / "calib.json"
    monkeypatch.setenv(hw.CALIB_ENV, str(out))
    assert ttune.main(["--calibrate", "--device", "cpu", "--scale",
                       "0.02"]) == 0
    assert set(json.loads(out.read_text())) == {"cpu"}


def test_calibration_needs_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        ttune.main(["--calibrate"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttune.measure(scale=0.02)


# What the planner's constants were before the card's unit: an entry of
# the first calibration protocol, as a user's cache may still hold it.
OLD_UNIT = {"ranked_fixed": 25.305, "pair_cost": 2.146,
            "ranked_iter_cost": 2.146, "packed_over": 5.754, "epi_cost": 0.0}
H100 = json.loads(pathlib.Path(hw.SHIPPED_CALIB).read_text())[
    "NVIDIA H100 80GB HBM3"]


def test_old_unit_entry_gives_way_to_the_cards_unit(monkeypatch, tmp_path,
                                                    capsys):
    """A cache in the old unit (no unit_ns) gives way to a later entry in
    the card's unit, with a warning naming tools.tune --calibrate; with
    none it is read in its own unit, every key it lacks at the
    reference's value, so it plans as the reference does on it."""
    user, shipped = tmp_path / "user.json", tmp_path / "shipped.json"
    user.write_text(json.dumps({"cpu": OLD_UNIT}))
    shipped.write_text(json.dumps({"cpu": H100}))
    monkeypatch.delenv(hw.CALIB_ENV, raising=False)
    monkeypatch.setattr(hw, "USER_CALIB", str(user))
    monkeypatch.setattr(hw, "SHIPPED_CALIB", str(shipped))
    assert hw.kernel_calibration() == H100
    assert "tpu_spmv_torch.tools.tune --calibrate" in capsys.readouterr().err
    shipped.write_text(json.dumps({"another card": H100}))
    assert hw.kernel_calibration() == OLD_UNIT
    assert tmodel._cal("span_cost", 1.0) == 1.0
    monkeypatch.setenv("TPU_SPMV_CALIB", str(tmp_path / "ref.json"))
    (tmp_path / "ref.json").write_text(json.dumps({"v5e": OLD_UNIT}))
    ref, port = _pair("wide_random_300k")
    assert_same_plan(jmodel.tpu_plan(ref, assume_rcm=True),
                     tmodel.tpu_plan(port, assume_rcm=True))
    # An entry in the card's unit in the user cache wins.
    user.write_text(json.dumps({"cpu": dict(H100, unit_ns=1.0)}))
    assert hw.kernel_calibration()["unit_ns"] == 1.0


def test_shipped_entry_holds_every_key_read(monkeypatch):
    """On the H100 no plan and no solve choice reads a module default:
    every key the planner and LowerSolveLayout.build read is in the
    shipped entry, and every key of the entry is read."""
    from tpu_spmv_torch.sts import host as thost
    from tpu_spmv_torch.sts.solve import LowerSolveLayout

    read = set()
    real = tmodel._cal

    def spy(name, default):
        read.add(name)
        return real(name, default)

    monkeypatch.setattr(hw, "kernel_calibration", lambda: dict(H100))
    monkeypatch.setattr(tmodel, "_cal", spy)
    for name in ("tools_general_50k", "stencil_8x2048", "lap2d_64",
                 "skewed_20k", "scattered_300k"):
        port = _pair(name)[1]
        tmodel.tpu_plan(port, assume_rcm=True)
        tmodel.tpu_plan(port, exact=False)
    sys_ = thost.build_sts(_pair("lap2d_64")[1], order_type="LS")
    lay = LowerSolveLayout.build(sys_, thost.compute_b(sys_.lower),
                                 device="cpu")
    assert lay.ranked is not None
    assert read == set(ttune.KEYS) - {"unit_ns"}, read ^ set(ttune.KEYS)
    assert read <= set(H100)


# One value for each cost key a card's entry adds, and the kinds of
# candidate whose est_cost it moves.
_MOVES = {
    "sell_fixed": (5.0, {"sell"}),
    "span_cost": (2.5, {"sell"}),
    "traffic_floor": (1e3, {"sell", "ranked", "packed", "dia"}),
    "dia_step_cost": (7.0, {"dia"}),
}


@pytest.mark.parametrize("key", sorted(_MOVES))
def test_new_key_moves_exactly_its_candidates(key, monkeypatch, tmp_path):
    """A pinned table that sets one key the card's entry adds moves the
    est_cost of exactly the candidates that key prices, and no other."""
    value, kinds = _MOVES[key]
    port = _pair("stencil_8x2048")[1]

    def costs(entry):
        pin_calibration(monkeypatch, tmp_path, entry)
        cands = []
        tmodel.tpu_plan(port, assume_rcm=True, candidates=cands)
        return [(k, w, c) for c, k, w, _, _ in cands]

    before, after = costs({}), costs({key: value})
    assert [c[:2] for c in before] == [c[:2] for c in after]
    assert {c[0] for c in before} >= kinds
    for (kind, w, c0), (_, _, c1) in zip(before, after):
        assert (c0 != c1) == (kind in kinds), (key, kind, w, c0, c1)


def test_span_limit_offers_and_withholds_sell(monkeypatch, tmp_path):
    """span_limit decides which sell candidates are offered (the chunk
    span, and each stripe's span, against it); the others' costs stay."""
    port = _pair("jittered_8x2048")[1]

    def cands(entry):
        pin_calibration(monkeypatch, tmp_path, entry)
        out = []
        tmodel.tpu_plan(port, assume_rcm=True, candidates=out)
        return out

    full, none = cands({"span_limit": 1e9}), cands({"span_limit": 0.5})
    assert any(k == "sell" for _, k, _, _, _ in full)
    assert not any(k == "sell" for _, k, _, _, _ in none)
    assert [c for c in full if c[1] != "sell"] == none


def test_ranked_iter_cost_steers_the_estimate_only_path(monkeypatch,
                                                        tmp_path):
    """ranked_iter_cost weighs the ranked span against the chunk span on
    the estimate-only path (exact=False), where est_cost is 0; the exact
    plan does not read it."""
    port = _pair("wide_random_300k")[1]

    def plan(entry, exact):
        pin_calibration(monkeypatch, tmp_path, entry)
        return tmodel.tpu_plan(port, assume_rcm=True, exact=exact)

    assert plan({"ranked_iter_cost": 1e-3}, False).kernel == "ranked"
    assert plan({"ranked_iter_cost": 1e3}, False).kernel == "sell"
    assert plan({"ranked_iter_cost": 1e3, "span_limit": 1.0},
                False).kernel == "segsum"
    exact = [plan({"ranked_iter_cost": v}, True) for v in (1e-3, 1e3)]
    assert exact[0] == exact[1]


def _synthetic_points(spans, unit_s: float, c: dict) -> dict:
    """measure_points' points for known constants `c` (in the unit) and
    a unit of unit_s seconds, the sell sweep at `spans`."""
    u = unit_s
    sell = [(s, u * (1.0 + c["span_cost"] * (s - ttune.UNIT_SPAN)), 100 + s)
            for s in spans]
    ranked = [(w, w, max((w + 1) // 2, 1),
               u * (c["ranked_fixed"] + c["pair_cost"] * max((w + 1) // 2, 1)),
               1000 // w) for w in ttune.RANKED_WIDTHS]
    ru = 0.4
    return dict(
        sell=sell,
        ranked_span=[(s, c["ranked_iter_cost"]) for s in spans],
        ranked=ranked,
        packed=(u * (ru + c["packed_over"]), u * ru),
        epi=((u * (ru + c["pair_cost"] + c["epi_cost"]), 1, 30),
             (u * (ru + c["pair_cost"]), 1, 32)),
        dia=u * c["dia_step_cost"],
        floor=u * c["traffic_floor"],
        solve={k: [(r, u * (c[f"solve_{k}_link"] + c[f"solve_{k}_round"] * r))
                   for r in (1.0, 2.0, 8.0)] for k in ("ranked", "blocks")},
    )


def test_fit_recovers_constants_at_any_span():
    """tools.tune.fit gives back the constants the points were made with,
    the same from a sell sweep at other spans and sample sizes: the unit
    (sell's time per sub-tile at UNIT_SPAN) does not depend on the
    sample, where the reference's (a sub-tile over its span) did."""
    c = dict(ranked_fixed=0.45, pair_cost=0.002, ranked_iter_cost=0.8,
             packed_over=0.03, epi_cost=0.01, span_cost=0.001,
             traffic_floor=0.3, dia_step_cost=0.25, solve_ranked_link=230.0,
             solve_ranked_round=95.0, solve_blocks_link=228.0,
             solve_blocks_round=110.0)
    fits = [ttune.fit(_synthetic_points(spans, 4.4e-9, c))
            for spans in ((8, 32, 128, 256), (16, 48, 200, 400))]
    for f, spans in zip(fits, ((8, 32, 128, 256), (16, 48, 200, 400))):
        assert tuple(f) == ttune.KEYS
        assert f["unit_ns"] == pytest.approx(4.4, rel=1e-3)
        for k, v in c.items():
            assert f[k] == pytest.approx(v, rel=2e-3, abs=1e-6), k
        assert f["sell_fixed"] == pytest.approx(1.0 - 0.3, rel=2e-3)
        assert f["span_limit"] == max(spans)
    assert {k: v for k, v in fits[0].items() if k != "span_limit"} == \
        {k: v for k, v in fits[1].items() if k != "span_limit"}
