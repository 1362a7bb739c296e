"""Warm times of the two triangular-solve kernels on their main systems,
for comparing two trees of the port on one card.

    python -m tpu_spmv_torch.bench.solve_times [--tag NAME]
        [--systems NAME [NAME ...]] [--grid N]

Times lower_solve_ranked and lower_solve_blocks (warm TimeMin, CUDA
graph, bench/harness.bench_spmv, twice each) on lap2d_1024 in level
(LS) and COLOR order, lap3d_101 LS, banded_1m LS (whose ranked layout
takes the column-binned windows), the bidiagonal chain and HPCG's
27-point system, one line per kernel and system, after the card's
nvidia-smi name and power limit. Each line also gives Number Wrong for
x = ones (tolerance 0.01). The chain's gives µs per link: the chain has
CHAIN_ROWS packs of one row, so CHAIN_ROWS chunks of one real slot each,
chunk c reading only chunk c - 1: the least a level of the chain costs,
with no slab work. `hpcg27` is the forward system of IC(0)-PCG on
HPCG's operator (26 on the diagonal, -1 for each of the 26 neighbours)
on a --grid cube (104, hpcg.dat's, by default) in natural order: the
IC(0) factor in level order as sts/ic0 builds it, 7 (N - 1) + 1 levels;
its line gives µs per level.

Where the tree's kernels take `counts=` (a counting instantiation), each
line is followed by the poll counters of counted solves: the slots a
solve reads (real ones, and padding that points at an earlier row), the
share of them whose first read found the row unsolved, and the mean
re-reads such a slot took.

The layouts come from `LowerSolveLayout.build(...)` and `.to("cuda")`,
and the script reads only fields every tree of the port has, so another
tree's package can be timed by running this file with that tree first
on PYTHONPATH:

    PYTHONPATH=<tree> python tpu_spmv_torch/bench/solve_times.py --tag parent
"""

from __future__ import annotations

import argparse
import inspect
import itertools

import numpy as np
import torch

from tpu_spmv_torch.bench.harness import bench_spmv

CHAIN_ROWS = 4096
# name -> (matrix spec, schedule order); None: built here (`system`).
SYSTEMS = {
    "lap2d_1024_LS": ("synthetic:lap2d_1024", "LS"),
    "lap2d_1024_COLOR": ("synthetic:lap2d_1024", "COLOR"),
    "lap3d_101_LS": ("synthetic:lap3d_101", "LS"),
    "banded_1m_LS": ("synthetic:banded_1m", "LS"),
    "chain": None,
    "hpcg27": None,
}
HPCG_GRID = 104


def bidiagonal_chain(n: int = CHAIN_ROWS):
    """Lower bidiagonal n x n CSRMatrix (2 on the diagonal, -1 below):
    x_i depends on x_{i-1} alone, so its level schedule is n packs of
    one row."""
    from tpu_spmv_torch.formats.csr import CSRMatrix

    i = np.arange(n)
    return CSRMatrix.from_coo(
        np.concatenate([i, i[1:]]), np.concatenate([i, i[:-1]]),
        np.concatenate([np.full(n, 2.0), np.full(n - 1, -1.0)]).astype(
            np.float32), (n, n),
    )


def hpcg27(n: int):
    """HPCG's operator on an n^3 grid (GenerateProblem_ref: 26 on the
    diagonal, -1 for each neighbour inside the grid), rows in natural
    order (x fastest), as a CSRMatrix."""
    from tpu_spmv_torch.formats.csr import CSRMatrix

    idx = np.arange(n ** 3).reshape(n, n, n)  # (z, y, x)
    rows, cols = [], []
    for dz, dy, dx in itertools.product((-1, 0, 1), repeat=3):
        src = idx[max(0, -dz):n - max(0, dz), max(0, -dy):n - max(0, dy),
                  max(0, -dx):n - max(0, dx)]
        rows.append(src.reshape(-1))
        cols.append((src + dz * n * n + dy * n + dx).reshape(-1))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = np.where(rows == cols, 26.0, -1.0).astype(np.float32)
    return CSRMatrix.from_coo(rows, cols, vals, (n ** 3, n ** 3))


def hpcg27_system(n: int):
    """The forward system of IC(0) on hpcg27(n): the factor L in level
    order, sort_packs=False (sts/ic0's own schedule)."""
    from tpu_spmv_torch.sts.host import build_sts
    from tpu_spmv_torch.sts.ic0 import ic0_factor

    L, _ = ic0_factor(hpcg27(n))
    return build_sts(L, order_type="LS", sort_packs=False)


def system(name: str, grid: int = HPCG_GRID):
    """The TriangularSystem of a SYSTEMS entry."""
    from tpu_spmv_torch.sts.host import build_sts
    from tpu_spmv_torch.tools.spmv import load_input

    if name == "chain":
        return build_sts(bidiagonal_chain(), order_type="LS")
    if name == "hpcg27":
        return hpcg27_system(grid)
    spec, order = SYSTEMS[name]
    return build_sts(load_input(spec), order_type=order)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--systems", nargs="+", default=list(SYSTEMS),
                    choices=list(SYSTEMS))
    ap.add_argument("--grid", type=int, default=HPCG_GRID,
                    help="the hpcg27 system's cube side")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the times are the card's")

    from tpu_spmv_torch import hw
    from tpu_spmv_torch.kernels.sts import (
        lower_solve_blocks, lower_solve_ranked,
    )
    from tpu_spmv_torch.sts.host import compute_b
    from tpu_spmv_torch.sts.solve import LowerSolveLayout

    print(hw.nvidia_smi(), flush=True)
    dev = torch.device("cuda")
    for name in args.systems:
        sys_ = system(name, args.grid)
        lay = LowerSolveLayout.build(sys_, compute_b(sys_.lower)).to(dev)
        per = {"chain": ("link", CHAIN_ROWS),
               "hpcg27": ("level", sys_.num_packs)}.get(name)
        for kind, fn, slabs in (
                ("ranked", lower_solve_ranked, lay.ranked),
                ("blocks", lower_solve_blocks, lay.slabs)):
            if slabs is not None:
                label = f"{args.tag} {name} {kind}"
                _time(label, fn, slabs, lay, sys_.lower.nnz, per)
                _count(label, fn, slabs, lay)
        del lay
    return 0


def _time(label, fn, slabs, lay, nnz, per):
    """One line: two warm TimeMins of fn on slabs, Number Wrong for
    x = ones, and, where per = (unit, count) is given, the us per unit
    (a link of the chain, a level of hpcg27)."""

    def solve(sl, bf):
        return fn(sl, bf.view(-1, 128))

    bflat = lay.b_scale.reshape(-1)
    x = solve(slabs, bflat).reshape(-1)[lay.pad_index].cpu().numpy()
    wrong = int(np.sum(np.abs(x - 1.0) > 0.01))
    t = [bench_spmv(solve, slabs, bflat, nnz=nnz).time_min for _ in range(2)]
    unit = (f" | {min(t) * 1e6 / per[1]:.3f} us per {per[0]} ({per[1]})"
            if per else "")
    print(f"{label}: warm TimeMin us {t[0] * 1e6:.2f} {t[1] * 1e6:.2f} | "
          f"Number Wrong {wrong}{unit}", flush=True)


def _count(label, fn, slabs, lay, solves: int = 3):
    """The poll counters of `solves` counted solves, where the tree's
    kernel has a counting instantiation: the slots read a solve, the
    share whose first read found the row unsolved, and the mean re-reads
    of such a slot."""
    if "counts" not in inspect.signature(fn).parameters:
        return
    counts = torch.zeros(3, dtype=torch.int64, device=lay.b_scale.device)
    for _ in range(solves):
        fn(slabs, lay.b_scale, counts=counts)
    read, missed, rereads = (int(v) for v in counts.cpu())
    print(f"{label}: poll counters over {solves} solves | slots read "
          f"{read // solves} a solve | first read unsolved "
          f"{100.0 * missed / max(read, 1):.2f}% | re-reads a waiting slot "
          f"{rereads / max(missed, 1):.2f}", flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
