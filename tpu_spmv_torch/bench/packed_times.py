"""Warm times of spmv_packed and spmm_packed beside spmv_ranked and
spmm_ranked on their main matrices, for comparing two trees of the port
on one card.

    python -m tpu_spmv_torch.bench.packed_times [--tag NAME]
        [--batches B [B ...]] [--runs Q,S [Q,S ...]]

On lap2d_1024 after RCM and banded_1m (RCM as the CLI's auto decides;
its chunk of an 887-nonzero row is split) it times (warm TimeMin, CUDA
graph, bench/harness.bench_spmv, twice each) spmv_packed and
spmv_ranked on their grouped layouts and spmm_packed and spmm_ranked at
each B (default 5 and 8), one line each with the kernel's largest
difference from its plain version, after the card's nvidia-smi name and
power limit. Then it prints R, the packed-to-ranked warm time per walked
sub-tile of each matrix, for SpMV and for SpMM at the first B (the
planner's packed surcharge is calibrated by tools.tune instead). It uses
only what
every tree of the port has, so another tree's package can be timed by
running this file with that tree first on PYTHONPATH.

--runs also times spmv_packed and spmm_packed on the packed layout with
its run table cut at each pair in turn: runs touching at most Q
sub-tiles and holding at most S segments (formats/packed.RUN_SUBTILES
and RUN_SEGMENTS; Q = 0 gives every segment a block of its own), where
the tree has a run table.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

MATRICES = (("lap2d_1024", "always"), ("banded_1m", "auto"))


def _time(fn, plain, lay, x, nnz: int) -> tuple:
    """(line, best warm TimeMin in seconds)."""
    from tpu_spmv_torch.bench.harness import bench_spmv

    y = fn(lay, x)
    yp = plain(lay, x)
    err = float((y - yp).abs().max()) / max(1.0, float(yp.abs().max()))
    del y, yp
    times = [bench_spmv(fn, lay, x, nnz=nnz).time_min for _ in range(2)]
    line = " ".join(f"{t * 1e6:.2f}" for t in times)
    return f"{line} (max|kernel-plain|/max(1,|plain|) {err:.2g})", min(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--batches", type=int, nargs="*", default=(5, 8))
    ap.add_argument("--runs", nargs="*", default=(),
                    type=lambda v: tuple(int(t) for t in v.split(",")))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the times are the card's")

    from tpu_spmv_torch import hw
    from tpu_spmv_torch.formats import packed as fpacked
    from tpu_spmv_torch.formats.packed import PackedRanked
    from tpu_spmv_torch.formats.sell import RankedSlabs
    from tpu_spmv_torch.kernels.packed import (
        spmv_packed, spmv_packed_reference,
    )
    from tpu_spmv_torch.kernels.sell import spmv_ranked, spmv_ranked_reference
    from tpu_spmv_torch.kernels.spmm import (
        spmm_packed, spmm_packed_reference, spmm_ranked,
        spmm_ranked_reference,
    )
    from tpu_spmv_torch.tools.spmv import load_input, prepare

    print(hw.nvidia_smi(), flush=True)
    dev = torch.device("cuda")
    for name, rcm in MATRICES:
        mat = load_input(f"synthetic:{name}")
        ck, perm = prepare(mat, rcm)
        packed = PackedRanked.from_csr(ck.matrix).to(dev)
        ranked = RankedSlabs.from_csr(ck.matrix).to(dev)
        subtiles = {"packed": int(packed.chunk_koff[-1]) / 8,
                    "ranked": int(ranked.chunk_ptr[-1])}
        rng = np.random.default_rng(0)
        best = {}
        xs = {}
        for B in (None, *args.batches):
            shape = (mat.n,) if B is None else (mat.n, B)
            x = rng.standard_normal(shape).astype(np.float32)
            xt = xs[B] = torch.from_numpy(x[perm]).to(dev)
            runs = (("packed", spmv_packed, spmv_packed_reference, packed),
                    ("ranked", spmv_ranked, spmv_ranked_reference, ranked))
            if B is not None:
                runs = (("packed", spmm_packed, spmm_packed_reference, packed),
                        ("ranked", spmm_ranked, spmm_ranked_reference, ranked))
            for kind, fn, plain, lay in runs:
                line, t = _time(fn, plain, lay, xt, mat.nnz)
                best[kind, B] = t
                print(f"{args.tag} {name} {fn.__name__}"
                      f"{'' if B is None else f' B={B}'}: warm TimeMin us "
                      f"{line}", flush=True)
        for B in (None, *args.batches[:1]):
            r = ((best["packed", B] / subtiles["packed"])
                 / (best["ranked", B] / subtiles["ranked"]))
            print(f"{args.tag} {name} R {'spmv' if B is None else f'spmm B={B}'}"
                  f" (packed/ranked warm time per walked sub-tile): {r:.3f} "
                  f"({subtiles['packed']:.0f} / {subtiles['ranked']} "
                  "sub-tiles)", flush=True)
        if not args.runs or not hasattr(packed, "run_ptr"):
            continue
        default = fpacked.RUN_SUBTILES, fpacked.RUN_SEGMENTS
        try:
            for q, most in args.runs:
                fpacked.RUN_SUBTILES, fpacked.RUN_SEGMENTS = q, most
                lay = fpacked.with_segments(packed)
                for B, xt in xs.items():
                    fn, plain = ((spmv_packed, spmv_packed_reference)
                                 if B is None else
                                 (spmm_packed, spmm_packed_reference))
                    line, _ = _time(fn, plain, lay, xt, mat.nnz)
                    print(f"{args.tag} {name} {fn.__name__}"
                          f"{'' if B is None else f' B={B}'} runs of "
                          f"{q} sub-tiles, {most} segments "
                          f"({lay.run_ptr.shape[1] - 1} runs): warm "
                          f"TimeMin us {line}", flush=True)
        finally:
            fpacked.RUN_SUBTILES, fpacked.RUN_SEGMENTS = default
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
