"""Warm times of spmv_ranked_windowed and spmm_ranked_windowed on their
main matrices, for comparing two trees of the port on one card.

    python -m tpu_spmv_torch.bench.window_times [--tag NAME]
        [--matrices lap2d_4096 lap2d_1024 banded_1m]
        [--step-subtiles Q [Q ...]]

Times (warm TimeMin, CUDA graph, bench/harness.bench_spmv, twice each)
spmv_ranked_windowed on lap2d_4096 after RCM (16.8M rows; x past the
L2) beside spmv_ranked on the same layout, spmm_ranked_windowed on
lap2d_1024 after RCM at B = 5 and 8, at the column passes the CLI's
fit_window picks, and spmv_ranked_windowed on banded_1m (its split chunk
takes the fix-up launch), one line each, after the card's nvidia-smi
name and power limit. It uses only what every tree of the port has, so
another tree's package can be timed by running this file with that tree
first on PYTHONPATH.

--step-subtiles also times each windowed phase with the layout's window
table cut at each Q in turn (RankedSlabs.with_steps), where the tree has
a window table.
"""

from __future__ import annotations

import argparse
import inspect

import numpy as np
import torch

MATRICES = ("lap2d_4096", "lap2d_1024", "banded_1m")


def _time(fn, lay, x, nnz: int) -> str:
    from tpu_spmv_torch.bench.harness import bench_spmv

    return " ".join(f"{bench_spmv(fn, lay, x, nnz=nnz).time_min * 1e6:.2f}"
                    for _ in range(2))


def _fit(lay, batch: int, dev, mat):
    """tools/spmv.fit_window in either tree's signature (an older tree
    rebuilds the layout at a smaller tile through a callback)."""
    from tpu_spmv_torch.formats.sell import RankedSlabs
    from tpu_spmv_torch.tools.spmv import fit_window

    if "rebuild" in inspect.signature(fit_window).parameters:
        return fit_window(lay, batch, dev,
                          lambda cap: RankedSlabs.from_csr(mat, tile_k=cap))
    return fit_window(lay, batch, dev)


def _passes(cols: int):
    """spmm_ranked_windowed over X in column passes of `cols`, as the
    CLI runs it (tools/spmm.build_spmm)."""
    from tpu_spmv_torch.kernels.spmm import spmm_ranked_windowed

    def run(lay, X):
        if X.shape[1] == cols:
            return spmm_ranked_windowed(lay, X)
        return torch.cat([spmm_ranked_windowed(lay, X[:, i:i + cols]
                                               .contiguous())
                          for i in range(0, X.shape[1], cols)], dim=1)
    return run


def _ring(lay) -> str:
    if getattr(lay, "step_lo", None) is None:
        return f"tile {lay.tile_k}, window {lay.win_span} blocks"
    return (f"ring {lay.ring_blocks} blocks, {lay.step_lo.numel()} steps of "
            f"{lay.step_subtiles}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--matrices", nargs="*", default=MATRICES,
                    choices=MATRICES)
    ap.add_argument("--step-subtiles", type=int, nargs="*", default=())
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the times are the card's")

    from tpu_spmv_torch import hw
    from tpu_spmv_torch.formats.sell import RankedSlabs
    from tpu_spmv_torch.kernels.sell import spmv_ranked, spmv_ranked_windowed
    from tpu_spmv_torch.tools.spmv import load_input, prepare

    print(hw.nvidia_smi(), flush=True)
    dev = torch.device("cuda")
    for name in args.matrices:
        mat = load_input(f"synthetic:{name}")
        ck, perm = prepare(mat, "auto" if name == "banded_1m" else "always")
        lay = RankedSlabs.from_csr(ck.matrix).to(dev)
        rng = np.random.default_rng(0)
        if name == "lap2d_1024":
            runs = []
            for B in (5, 8):
                X = rng.standard_normal((mat.n, B)).astype(np.float32)
                at_b, cols = _fit(lay, B, dev, ck.matrix)
                runs.append((f"spmm B={B} in {-(-B // cols)} pass(es)",
                             _passes(cols), at_b,
                             torch.from_numpy(X[perm]).to(dev), mat.nnz * B))
        else:
            x = rng.standard_normal(mat.n).astype(np.float32)
            xt = torch.from_numpy(x[perm]).to(dev)
            at_1, _ = _fit(lay, 1, dev, ck.matrix)
            runs = [("spmv", spmv_ranked_windowed, at_1, xt, mat.nnz)]
            print(f"{args.tag} {name} spmv_ranked on the same layout: warm "
                  f"TimeMin us {_time(spmv_ranked, at_1, xt, mat.nnz)}",
                  flush=True)
        for kind, fn, at, x, nnz in runs:
            print(f"{args.tag} {name} {kind} ({_ring(at)}): warm TimeMin us "
                  f"{_time(fn, at, x, nnz)}", flush=True)
            if not hasattr(at, "with_steps"):
                continue
            for q in args.step_subtiles:
                at_q = at.with_steps(q)
                try:
                    t = _time(fn, at_q, x, nnz)
                except ValueError as e:  # a ring past shared memory
                    t = f"refused ({e})"
                print(f"{args.tag} {name} {kind} Q={q} ({_ring(at_q)}): "
                      f"warm TimeMin us {t}", flush=True)
        del lay, runs
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
