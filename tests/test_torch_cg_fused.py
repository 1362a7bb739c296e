"""Where the fused CG iteration engages (dist/solvers.fused), on the CPU.

On the card a CG iteration over a ShardedRanked layout runs as three
hand-written kernels a shard (kernels/cg.py); everywhere else (the CPU,
ShardedSell, OverlapRanked, a gloo group, plain=True, Jacobi-PCG) the
composed step runs, and `_step_fn` says which in the counters
`cg.fused_shards` of `cg.local_shards`, which the benchmark's
`cg_fused.<solver>` reads. The kernels themselves run in
tests/test_torch_gpu.py; here: the rule, the counters, the composed
step on the CPU, the reader, and the C entries' argument counts against
their ctypes signatures.
"""

import pathlib
import re
import sys

import numpy as np
import pytest
import torch

from tpu_spmv_torch import obs
from tpu_spmv_torch.bench.matrices import random_banded
from tpu_spmv_torch.dist import sharding as dsh
from tpu_spmv_torch.dist import solvers
from tpu_spmv_torch.kernels import _build

_LAYOUTS = {"ranked": dsh.ShardedRanked, "sell": dsh.ShardedSell,
            "overlap": dsh.OverlapRanked}


@pytest.fixture(autouse=True)
def _clean_counters():
    obs.reset()
    yield
    obs.reset()


@pytest.fixture(scope="module")
def mat():
    return random_banded(2500, 30, 6, seed=3)


def _card_mesh(D, backend=None, monkeypatch=None):
    """A RowMesh that says its D shards lie on one CUDA card (nothing is
    placed: the rule reads the mesh alone)."""
    mesh = dsh.RowMesh([torch.device("cuda", 0)] * D, [None] * D, [None] * D)
    if backend is not None:
        mesh.world = 2
        monkeypatch.setattr(dsh.RowMesh, "backend",
                            property(lambda self: backend))
    return mesh


def _counted(layout, mesh, inv_diag=None):
    solvers._step_fn(layout, mesh, inv_diag, "rows")
    got = obs.counters()
    return got["cg.fused_shards"], got["cg.local_shards"]


@pytest.mark.parametrize("kind, D", [
    ("ranked", 1), ("ranked", 4), ("sell", 1), ("sell", 4), ("overlap", 2),
    ("overlap", 4)])
def test_the_cpu_takes_the_composed_step(mat, kind, D):
    mesh = dsh.make_row_mesh(["cpu"] * D)
    lay = _LAYOUTS[kind].build(mat, D).device_put(mesh)
    assert not solvers.fused(lay, mesh)
    assert _counted(lay, mesh) == (0, D)


@pytest.mark.parametrize("kind", ["sell", "overlap"])
def test_other_layouts_take_the_composed_step_on_a_card(mat, kind):
    lay = _LAYOUTS[kind].build(mat, 4)
    assert not solvers.fused(lay, _card_mesh(4))
    assert _counted(lay, _card_mesh(4)) == (0, 4)


@pytest.mark.parametrize("D", [1, 4])
def test_sharded_ranked_on_a_card_takes_the_fused_step(mat, D, monkeypatch):
    lay = dsh.ShardedRanked.build(mat, D)
    assert solvers.fused(lay, _card_mesh(D))
    # (no card here: the scratch a fused step function makes is a token)
    monkeypatch.setattr(solvers, "fused_scratch", lambda lay, mesh: "held")
    assert _counted(lay, _card_mesh(D)) == (D, D)
    # The plain versions, and Jacobi-PCG, stay composed.
    assert not solvers.fused(lay, _card_mesh(D), plain=True)
    inv = [torch.ones(lay.rows_per_shard)] * D
    assert _counted(lay, _card_mesh(D), inv_diag=inv) == (0, D)


def test_a_gloo_group_takes_the_composed_step(mat, monkeypatch):
    lay = dsh.ShardedRanked.build(mat, 4)
    assert solvers.fused(lay, _card_mesh(4, "nccl", monkeypatch))
    mesh = _card_mesh(4, "gloo", monkeypatch)
    assert not solvers.fused(lay, mesh)
    assert _counted(lay, mesh) == (0, 4)


def test_a_step_function_keeps_its_own_scratch(mat, monkeypatch):
    """_step_fn makes the fused step's scratch once and hands it to every
    call of its function (a captured iteration replays on it); another
    step function, as a second capture of one layout makes, gets its
    own."""
    lay = dsh.ShardedRanked.build(mat, 4)
    made, used = [], []

    def scratch(layout, mesh):
        made.append(object())
        return made[-1]

    def step(layout, mesh, state, axis, held):
        used.append(held)
        return state

    monkeypatch.setattr(solvers, "fused_scratch", scratch)
    monkeypatch.setattr(solvers, "_fused_step", step)
    one = solvers._step_fn(lay, _card_mesh(4), None, "rows")
    two = solvers._step_fn(lay, _card_mesh(4), None, "rows")
    one("state"), one("state"), two("state")
    assert len(made) == 2 and made[0] is not made[1]
    assert used == [made[0], made[0], made[1]]


def _process_mesh(D, world, rank):
    """Process `rank`'s RowMesh of a `world`-process group: its D / world
    shards (hosts-major) on the CPU, None for the others'."""
    per = D // world
    devices = [torch.device("cpu") if d // per == rank else None
               for d in range(D)]
    return dsh.RowMesh(devices, [None] * D, [None] * D, rank=rank,
                       world=world)


@pytest.mark.parametrize("world, rank", [(2, 0), (2, 1), (4, 2)])
def test_fused_partials_cross_processes_in_shard_order(mat, monkeypatch,
                                                       world, rank):
    """Across processes (D = 4 shards over `world` of them), _fused_step
    all-gathers this process's own slots of p.Ap and of r.r, and every
    shard's K2 and K3 get the D partials in shard order, the order in
    which _dot adds them; K3 of this process's last shard alone writes
    rz. The kernels, the exchange and the collective are stand-ins that
    write and record the shard each partial came from."""
    D = 4
    mesh = _process_mesh(D, world, rank)
    per = D // world
    lay = dsh.ShardedRanked.build(mat, D)
    gathered, updates, directions = [], [], []

    def all_gather_rows(mesh_, own):
        assert mesh_ is mesh and own.shape == (per,)
        gathered.append(own.clone())
        base = own[0] - mesh.local[0]  # 10 for p.Ap, 20 for r.r
        return torch.cat([own if q == rank else
                          base + torch.arange(q * per, (q + 1) * per,
                                              dtype=own.dtype)
                          for q in range(world)])

    def walk(layout, xs, mesh_, kernel, axis):
        return [kernel(d, layout.shards[d], xs[d]) if d in mesh_.local
                else None for d in range(D)]

    def ranked_dot(lay_, win, p, held, into):
        into.fill_(10 + held)
        return torch.zeros_like(p)

    def update(pap, rz, p, ap, x, r, held, rr_out):
        updates.append((held, pap.tolist()))
        rr_out.fill_(20 + held)

    def direction(rr, rz, r, p, held):
        directions.append((rr.tolist(), held))

    monkeypatch.setattr(solvers.group, "all_gather_rows", all_gather_rows)
    monkeypatch.setattr(solvers, "sharded_call", walk)
    monkeypatch.setattr(solvers.cg_kernels, "spmv_ranked_dot", ranked_dot)
    monkeypatch.setattr(solvers.cg_kernels, "cg_update", update)
    monkeypatch.setattr(solvers.cg_kernels, "cg_direction", direction)
    vec = [torch.zeros(lay.rows_per_shard) if d in mesh.local else None
           for d in range(D)]
    state = (vec, vec, vec, torch.ones(()))
    held = [d if d in mesh.local else None for d in range(D)]
    out = solvers._fused_step(lay, mesh, state, "rows",
                              (held, torch.zeros(2, D)))
    assert out is state
    own = [float(d) for d in mesh.local]
    assert [g.tolist() for g in gathered] == [[10 + d for d in own],
                                              [20 + d for d in own]]
    assert updates == [(d, [10.0, 11.0, 12.0, 13.0]) for d in mesh.local]
    assert directions == [([20.0, 21.0, 22.0, 23.0],
                           d if d == mesh.local[-1] else None)
                          for d in mesh.local]


@pytest.mark.parametrize("D", [1, 4])
def test_the_composed_step_on_the_cpu_leaves_its_state(mat, D):
    """On the CPU cg_step is the composed step whether plain or not: a
    new state, the old one untouched, the same bits both ways."""
    mesh = dsh.make_row_mesh(["cpu"] * D)
    lay = dsh.ShardedRanked.build(mat, D).device_put(mesh)
    b = dsh.shard_vector(np.linspace(1, 2, mat.m, dtype=np.float32), mesh,
                         lay.padded_m)
    state = solvers.cg_init(b, mesh)
    kept = [[t.clone() for t in v] for v in state[:3]]
    new = solvers.cg_step(lay, mesh, state)
    plain = solvers.cg_step(lay, mesh, state, plain=True)
    for old, k, n, p in zip(state[:3], kept, new[:3], plain[:3]):
        assert all(torch.equal(a, c) for a, c in zip(old, k))
        assert all(a is not c for a, c in zip(old, n))
        assert all(torch.equal(a, c) for a, c in zip(n, p))
    assert torch.equal(new[3], plain[3]) and new[3] is not state[3]


def test_cg_fused_reader(monkeypatch):
    """spmv_bench/metrics/cg_fused.py: 100 x fused / local shards from
    the program's counters, None without them."""
    from spmv_bench import run as harness

    read = harness.reader("cg_fused.cg")
    for name in ("cg_fused.cg", "cg_fused.cg_x4"):
        assert harness.reader(name).__module__.endswith(".cg_fused")
    assert read(None) is None  # the recorder holds no counters
    obs.set_counters({"cg.fused_shards": 1, "cg.local_shards": 1})
    assert read(None) == 100.0
    obs.set_counters({"cg.fused_shards": 0, "cg.local_shards": 4})
    assert read(None) == 0.0
    obs.reset()
    obs.set_counters({"cg.fused_shards": 1})
    assert read(None) is None
    monkeypatch.delitem(sys.modules, "tpu_spmv_torch.obs")
    assert read(None) is None


def _c_entries() -> dict:
    """{name: argument count} of every `extern "C" int` in csrc/*.cu."""
    found = {}
    for src in _build.sources():
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            args = m.group(2).strip()
            found[m.group(1)] = 0 if args in ("", "void") else (
                args.count(",") + 1)
    return found


def test_every_signature_matches_its_c_entry():
    entries = _c_entries()
    for name, args in _build._SIGNATURES.items():
        assert name in entries, name
        assert entries[name] == len(args), name
    for name in ("tsp_spmv_ranked_dot", "tsp_cg_update", "tsp_cg_direction"):
        assert name in _build._SIGNATURES
    assert pathlib.Path(_build.CSRC_DIR, "grid_sum.cuh").is_file()
