"""The DIA route (kernels/dia.dia_route): which of spmv_dia and
spmv_dia_windowed a layout takes, from its x, the ring that fits shared
memory and its band's L2 reuse window, in this order:

1. the padded x within half the L2 -> resident ("x fits");
2. the ring fits -> windowed ("one ring");
3. the reuse window (span rows x (D values + 4 B of y + 4 B of x))
   within half the L2 -> resident ("reuse window");
4. otherwise resident ("past the window"; never dia_ring's ValueError).

The grids the card runs are held at their real offsets, rows, D and
value size with no values behind them (a meta tensor stands for vals),
at the H100's L2 and shared memory; small layouts with those two
patched drive build_layout on the CPU through every rule.
"""

import itertools
import types

import pytest
import torch

from tpu_spmv_torch import hw, obs
from tpu_spmv_torch.bench.matrices import laplacian_2d
from tpu_spmv_torch.bench.solve_times import hpcg27
from tpu_spmv_torch.formats.dia import DiaSlabs
from tpu_spmv_torch.formats.sell import LANES
from tpu_spmv_torch.kernels import dia as kdia
from tpu_spmv_torch.tools import spmv as spmv_cli

H100_BUDGET = hw.H100_L2_BYTES // 2


def _shape(offsets, m, dtype=torch.float32):
    """A stand-in for DiaSlabs.from_csr's layout of m rows with these
    offsets: its tile (32768 rows for f32 values) and vals' shape, on the
    meta device, so a 16.8M-row grid costs nothing."""
    tile = min(65536 if dtype == torch.bfloat16 else 32768,
               -(-m // 1024) * 1024)
    tiles = -(-m // tile)
    vals = torch.empty((tiles, len(offsets), tile // LANES, LANES),
                       dtype=dtype, device="meta")
    return types.SimpleNamespace(offsets=tuple(sorted(offsets)), vals=vals,
                                 num_blocks=tiles * tile // LANES, m=m, n=m)


def _ring_at(lay, rows):
    """The ring and stages of `rows` a step for a layout's offsets."""
    return kdia._ring_size(lay.offsets, lay.vals.element_size(), rows)


def _hpcg(nx, nz=None):
    nz = nz or nx
    offs = {dz * nx * nx + dy * nx + dx
            for dz, dy, dx in itertools.product((-1, 0, 1), repeat=3)}
    return _shape(offs, nx * nx * nz)


def _lap2d(n):
    return _shape((-n, -1, 0, 1, n), n * n)


def _lap3d(n):
    return _shape((-n * n, -n, -1, 0, 1, n, n * n), n ** 3)


def _wide_band():
    """200 diagonals 10,000 rows apart on 50M rows: the ring and stages
    are past any shared memory, and the band's window (2M rows of 808 B)
    is far past the L2."""
    return _shape(range(-1_000_000, 1_000_000, 10_000), 50_000_000)


@pytest.mark.parametrize("case,kernel,rule", [
    ("hpcg27_104", "resident", "x fits"),
    ("lap2d_1024", "resident", "x fits"),
    ("lap2d_4096", "windowed", "one ring"),
    ("hpcg27_256", "resident", "reuse window"),
    ("lap3d_256", "resident", "reuse window"),
    ("hpcg27_512x512x64", "resident", "past the window"),
    ("wide_band", "resident", "past the window"),
])
def test_route_of_the_cards_grids(case, kernel, rule):
    layout = {
        "hpcg27_104": lambda: _hpcg(104),
        "lap2d_1024": lambda: _lap2d(1024),
        "lap2d_4096": lambda: _lap2d(4096),
        "hpcg27_256": lambda: _hpcg(256),
        "lap3d_256": lambda: _lap3d(256),
        "hpcg27_512x512x64": lambda: _hpcg(512, 64),
        "wide_band": _wide_band,
    }[case]()
    route = kdia.dia_route(layout)
    assert (route.kernel, route.rule) == (kernel, rule)
    assert route.budget_bytes == H100_BUDGET
    assert (route.ring is not None) == (kernel == "windowed")
    if rule != "x fits":
        assert route.x_bytes > H100_BUDGET


def test_hpcg_256_reuse_window_is_58_percent_of_the_budget():
    """NVIDIA's HPCG grid, 256^3 a GPU: x (67 MB) is past half the L2,
    its one ring (~555 KB) past shared memory, and its band spans 131,586
    rows of 27 f32 values, y and x: 15.26 MB, within the 26.2 MB budget."""
    route = kdia.dia_route(_hpcg(256))
    assert route.window_bytes == 131_586 * (27 * 4 + 8) == 15_263_976
    assert route.window_bytes / route.budget_bytes == pytest.approx(
        0.5823, abs=1e-4)
    assert route.x_bytes == 4 * (515 + 131_072 + 516) * LANES
    assert _ring_at(_hpcg(256), LANES).smem > hw.H100_SMEM_PER_BLOCK
    assert route.ring is None


def test_hpcg_104_stays_resident_by_its_x():
    route = kdia.dia_route(_hpcg(104))
    assert route.rule == "x fits" and route.x_bytes <= H100_BUDGET
    assert route.window_bytes == 21_842 * 116
    assert 100 * route.window_bytes / route.budget_bytes == pytest.approx(
        9.67, abs=0.01)


def test_lap2d_4096_keeps_the_windowed_kernel_though_its_window_fits():
    """The ring is tested before the reuse window: the windowed kernel
    stages x once there, and ran faster (161 against 166 us on an
    H100)."""
    route = kdia.dia_route(_lap2d(4096))
    assert route.window_bytes <= route.budget_bytes
    assert route.kernel == "windowed" and route.ring.step_rows == 1024
    assert not kdia.dia_x_fits(_lap2d(4096))


def test_27_point_512x512x64_has_no_ring_and_is_resident():
    """Its window (60.9 MB) is past the budget and no ring fits shared
    memory, so spmv_dia runs it."""
    route = kdia.dia_route(_hpcg(512, 64))
    assert route.window_bytes == 525_314 * 116
    assert route.window_bytes / route.budget_bytes > 2.3
    with pytest.raises(ValueError, match="shared-memory budget"):
        kdia.dia_ring(_hpcg(512, 64), hw.H100_SMEM_PER_BLOCK)
    assert route.kernel == "resident" and route.ring is None


def test_a_band_no_ring_fits_routes_resident_and_raises_nothing():
    with pytest.raises(ValueError, match="shared-memory budget"):
        kdia.dia_ring(_wide_band(), hw.H100_SMEM_PER_BLOCK)
    route = kdia.dia_route(_wide_band())
    assert route.kernel == "resident" and route.ring is None
    assert route.window_bytes > route.budget_bytes


def test_the_window_charges_the_value_size():
    f32 = kdia.l2_window_bytes((-10, 0, 10), 4)
    assert f32 == 20 * (3 * 4 + 8)
    assert kdia.l2_window_bytes((-10, 0, 10), 2) == 20 * (3 * 2 + 8)
    assert kdia.l2_window_bytes((0,), 4) == 0


def test_the_route_follows_the_l2_it_is_given(monkeypatch):
    """The budget is half of the L2 hw reports (the card's on the card):
    an L2 twice the window holds HPCG 256^3's window, one byte less
    does not, and both keep it resident."""
    window = kdia.l2_window_bytes(_hpcg(256).offsets, 4)
    monkeypatch.setattr(hw, "H100_L2_BYTES", 2 * window)
    assert kdia.dia_route(_hpcg(256)).rule == "reuse window"
    monkeypatch.setattr(hw, "H100_L2_BYTES", 2 * window - 2)
    route = kdia.dia_route(_hpcg(256))
    assert (route.kernel, route.rule) == ("resident", "past the window")


@pytest.mark.parametrize("case", ["hpcg27_256", "lap2d_4096", "hpcg27_104"])
def test_the_route_sets_its_counters_once(case):
    layout = {"hpcg27_256": lambda: _hpcg(256),
              "lap2d_4096": lambda: _lap2d(4096),
              "hpcg27_104": lambda: _hpcg(104)}[case]()
    obs.reset()
    route = kdia.dia_route(layout)
    assert obs.counters() == {
        "dia.route_resident": int(route.kernel == "resident"),
        "dia.l2_window_bytes": route.window_bytes,
        "dia.l2_budget_bytes": H100_BUDGET,
    }


def _small(case):
    """(matrix, L2 bytes, shared memory) that send a small layout down
    one rule each: hpcg27(16, nz=64)'s x is just past a budget its window
    fits, and at 30,000 B no ring fits it; hpcg27(48, nz=4)'s ring misses
    its shared memory by one byte at 128 rows."""
    if case in ("x fits", "one ring"):
        mat = laplacian_2d(64)
        return mat, (hw.H100_L2_BYTES if case == "x fits" else 0), (
            hw.H100_SMEM_PER_BLOCK)
    if case == "ring a byte short":
        mat = hpcg27(48, nz=4)
        return mat, 0, _ring_at(DiaSlabs.from_csr(mat), LANES).smem - 1
    mat = hpcg27(16, nz=64)
    lay = DiaSlabs.from_csr(mat)
    x = kdia._padded_x_bytes(lay)
    window = kdia.l2_window_bytes(lay.offsets, 4)
    assert window < x
    return mat, 2 * (x - 1 if case == "reuse window" else window - 1), 30_000


@pytest.mark.parametrize("case,rule,fn", [
    ("x fits", "x fits", kdia.spmv_dia),
    ("one ring", "one ring", kdia.spmv_dia_windowed),
    ("reuse window", "reuse window", kdia.spmv_dia),
    ("ring a byte short", "past the window", kdia.spmv_dia),
    ("no ring", "past the window", kdia.spmv_dia),
])
def test_build_layout_takes_the_kernel_the_route_names(
        case, rule, fn, monkeypatch, capsys):
    mat, l2, smem = _small(case)
    monkeypatch.setattr(hw, "H100_L2_BYTES", l2)
    monkeypatch.setattr(hw, "H100_SMEM_PER_BLOCK", smem)
    obs.reset()
    layout, got, kernel = spmv_cli.build_layout(mat, "dia", device="cpu")
    out = capsys.readouterr().out
    assert kernel == "dia" and got is fn
    counters = obs.counters()
    route = kdia.dia_route(layout)
    assert route.rule == rule and counters == route.counters
    assert counters["dia.route_resident"] == int(fn is kdia.spmv_dia)
    assert f"DIA route ({rule})" in out
    assert str(route.budget_bytes) in out
    if rule != "x fits":
        assert "exceeds the L2 residency budget" in out
    if rule in ("reuse window", "past the window"):
        assert str(route.window_bytes) in out
    x = torch.randn(mat.n)
    assert torch.allclose(got(layout, x), kdia.spmv_dia_reference(layout, x),
                          atol=1e-4)
