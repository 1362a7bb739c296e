"""Warm times of spmv_ranked and spmv_sell on their main matrices, for
comparing two trees of the port on one card.

    python -m tpu_spmv_torch.bench.walk_times [--tag NAME]
        [--segment-subtiles Q [Q ...]]

Times (warm TimeMin, CUDA graph, bench/harness.bench_spmv, twice each)
spmv_ranked grouped and ungrouped and spmv_sell on banded_1m (RCM as
the CLI's auto decides) and lap2d_1024 after RCM, one line each, after
the card's nvidia-smi name and power limit. It uses only what every
tree of the port has, so another tree's package can be timed by
running this file with that tree first on PYTHONPATH.

--segment-subtiles also times banded_1m's ranked (grouped) and sell
layouts with their segment table cut at each Q in turn
(formats/sell.SEGMENT_SUBTILES, which the layouts' builders read).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

MATRICES = (("banded_1m", "auto"), ("lap2d_1024", "always"))


def _time(fn, lay, x, nnz: int) -> str:
    from tpu_spmv_torch.bench.harness import bench_spmv

    return " ".join(f"{bench_spmv(fn, lay, x, nnz=nnz).time_min * 1e6:.2f}"
                    for _ in range(2))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--segment-subtiles", type=int, nargs="*", default=())
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the times are the card's")

    from tpu_spmv_torch import hw
    from tpu_spmv_torch.formats import sell as fsell
    from tpu_spmv_torch.kernels.sell import spmv_ranked, spmv_sell
    from tpu_spmv_torch.tools.spmv import load_input, prepare

    print(hw.nvidia_smi(), flush=True)
    dev = torch.device("cuda")
    builds = (
        ("ranked grouped", spmv_ranked, fsell.RankedSlabs.from_csr),
        ("ranked ungrouped", spmv_ranked,
         lambda m: fsell.RankedSlabs.from_csr(m, allow_groups=False)),
        ("sell", spmv_sell, fsell.SellSlabs.from_csr),
    )
    for name, rcm in MATRICES:
        mat = load_input(f"synthetic:{name}")
        ck, perm = prepare(mat, rcm)
        x = np.random.default_rng(0).standard_normal(mat.n).astype(np.float32)
        xt = torch.from_numpy(x[perm]).to(dev)
        for kind, fn, build in builds:
            lay = build(ck.matrix)
            print(f"{args.tag} {name} {kind}: warm TimeMin us "
                  f"{_time(fn, lay.to(dev), xt, mat.nnz)}", flush=True)
            if (name != "banded_1m" or kind == "ranked ungrouped"
                    or not args.segment_subtiles):
                continue
            default = fsell.SEGMENT_SUBTILES
            try:
                for q in args.segment_subtiles:
                    fsell.SEGMENT_SUBTILES = q
                    at_q = fsell.with_segments(lay)
                    print(f"{args.tag} {name} {kind} Q={q} "
                          f"({at_q.seg_chunk.numel()} segments, "
                          f"{at_q.split_seg.shape[1]} split chunks): warm "
                          f"TimeMin us {_time(fn, at_q.to(dev), xt, mat.nnz)}",
                          flush=True)
            finally:
                fsell.SEGMENT_SUBTILES = default
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
