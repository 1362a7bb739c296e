"""Warm times of the two triangular-solve kernels on their main systems,
for comparing two trees of the port on one card.

    python -m tpu_spmv_torch.bench.solve_times [--tag NAME]
        [--systems NAME [NAME ...]]

Times lower_solve_ranked and lower_solve_blocks (warm TimeMin, CUDA
graph, bench/harness.bench_spmv, twice each) on lap2d_1024 in level
(LS) and COLOR order, lap3d_101 LS, banded_1m LS (whose ranked layout
takes the column-binned windows) and the bidiagonal chain, one line per
kernel and system, after the card's nvidia-smi name and power limit.
Each line also gives Number Wrong for x = ones (tolerance 0.01); the
chain's gives µs per link: the chain has CHAIN_ROWS packs of one row,
so CHAIN_ROWS chunks of one real slot each, chunk c reading only chunk
c - 1: the least a level of the chain costs, with no slab work.

The layouts come from `LowerSolveLayout.build(...)` and `.to("cuda")`,
and the script reads only fields every tree of the port has, so another
tree's package can be timed by running this file with that tree first
on PYTHONPATH:

    PYTHONPATH=<tree> python tpu_spmv_torch/bench/solve_times.py --tag parent
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tpu_spmv_torch.bench.harness import bench_spmv

CHAIN_ROWS = 4096
# name -> (matrix spec, schedule order); None is the bidiagonal chain.
SYSTEMS = {
    "lap2d_1024_LS": ("synthetic:lap2d_1024", "LS"),
    "lap2d_1024_COLOR": ("synthetic:lap2d_1024", "COLOR"),
    "lap3d_101_LS": ("synthetic:lap3d_101", "LS"),
    "banded_1m_LS": ("synthetic:banded_1m", "LS"),
    "chain": None,
}


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


def system(name: str):
    """The TriangularSystem of a SYSTEMS entry."""
    from tpu_spmv_torch.sts.host import build_sts
    from tpu_spmv_torch.tools.spmv import load_input

    if SYSTEMS[name] is None:
        return build_sts(bidiagonal_chain(), order_type="LS")
    spec, order = SYSTEMS[name]
    return build_sts(load_input(spec), order_type=order)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--systems", nargs="+", default=list(SYSTEMS),
                    choices=list(SYSTEMS))
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
        sys_ = system(name)
        lay = LowerSolveLayout.build(sys_, compute_b(sys_.lower)).to(dev)
        for kind, fn, slabs in (
                ("ranked", lower_solve_ranked, lay.ranked),
                ("blocks", lower_solve_blocks, lay.slabs)):
            if slabs is not None:
                _time(f"{args.tag} {name} {kind}", fn, slabs, lay,
                      sys_.lower.nnz, SYSTEMS[name] is None)
        del lay
    return 0


def _time(label, fn, slabs, lay, nnz, chain):
    """One line: two warm TimeMins of fn on slabs, Number Wrong for
    x = ones, and on the chain the us per link."""

    def solve(sl, bf):
        return fn(sl, bf.view(-1, 128))

    bflat = lay.b_scale.reshape(-1)
    x = solve(slabs, bflat).reshape(-1)[lay.pad_index].cpu().numpy()
    wrong = int(np.sum(np.abs(x - 1.0) > 0.01))
    t = [bench_spmv(solve, slabs, bflat, nnz=nnz).time_min for _ in range(2)]
    link = (f" | {min(t) * 1e6 / CHAIN_ROWS:.3f} us per link" if chain
            else "")
    print(f"{label}: warm TimeMin us {t[0] * 1e6:.2f} {t[1] * 1e6:.2f} | "
          f"Number Wrong {wrong}{link}", flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
