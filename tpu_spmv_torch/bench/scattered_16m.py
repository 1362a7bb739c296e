"""The scattered datapoint on the card: a matrix whose x is past the L2
runs the column-striped passes.

    python -m tpu_spmv_torch.bench.scattered_16m [--device cuda|cpu]

Counterpart of results/scattered_16m_r3.py. The matrix is
bench/matrices.py's scattered_16m (131,072 rows, 16,777,216 columns,
160 uniformly random columns a row: x alone is 64 MB, past half the
H100's 50 MB L2, with no band locality for the windowed ring). The bin
width W is the one of {16, 32, 64} whose striped layout pads least on a
sample of the first 64 chunks (pick_bin_blocks, as the reference script
picks it). It runs the f32 striped call (kernels/striped.py) and the
bf16-values datum on the same stripes (the CLI stores bf16 there only
where the card's calibration, tools.tune's striped_bf16, times it
faster), validates each against the oracle
(bf16 against the bf16-rounded operator) and times each warm and cold
(bench/harness.py), printing the reference's keys (wrong, rel, gflops,
gnnzs, time_min) and the card's nvidia-smi name and power limit.

SCAT_M, SCAT_N, SCAT_PER_ROW and SCAT_STRIPE_COLS shrink the run, as
they do the reference script's; `--device cpu` then validates the plain
versions and prints no time.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

SAMPLE_CHUNKS = 64
BIN_CHOICES = (16, 32, 64)


def pick_bin_blocks(mat, stripe_cols=None):
    """(W, padding) of the bin width in BIN_CHOICES whose striped layout
    (stripes of stripe_cols, default_stripe_cols when None) pads least on
    the first SAMPLE_CHUNKS chunks of rows, built on the host."""
    from tpu_spmv_torch.formats.csr import CSRMatrix
    from tpu_spmv_torch.kernels.striped import StripedRanked

    sm = min(mat.m, SAMPLE_CHUNKS * 128)
    e = int(mat.indptr[sm])
    sample = CSRMatrix(mat.indptr[: sm + 1], mat.indices[:e], mat.data[:e],
                       (sm, mat.n))
    best_w, best_pad = BIN_CHOICES[0], float("inf")
    for w in BIN_CHOICES:
        try:
            s = StripedRanked.from_csr(sample, stripe_cols=stripe_cols,
                                       bin_blocks=w, device="cpu")
        except ValueError:
            continue
        if s.padding_ratio < best_pad:
            best_w, best_pad = w, s.padding_ratio
    return best_w, best_pad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    timed = dev.type == "cuda"
    if timed and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the times are the card's "
                         "(--device cpu validates a shrunk run only)")

    from tpu_spmv_torch import hw
    from tpu_spmv_torch.bench.harness import (
        bench_spmv, bench_spmv_cold, validate,
    )
    from tpu_spmv_torch.bench.matrices import scattered_wide
    from tpu_spmv_torch.kernels.striped import StripedRanked, spmv_striped

    m = int(os.environ.get("SCAT_M", 131_072))
    n = int(os.environ.get("SCAT_N", 16_777_216))
    per_row = int(os.environ.get("SCAT_PER_ROW", 160))
    sc = int(os.environ.get("SCAT_STRIPE_COLS", 0)) or None
    if timed:
        print(hw.nvidia_smi(), flush=True)
    mat = scattered_wide(m, n, per_row)
    w, _ = pick_bin_blocks(mat, sc)
    x_np = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    x = torch.from_numpy(x_np).to(dev)
    ok = True
    for tag, vdt, oracle in (("f32", None, mat),
                             ("bf16", torch.bfloat16, mat.rounded())):
        lay = StripedRanked.from_csr(mat, stripe_cols=sc, bin_blocks=w,
                                     val_dtype=vdt, device=dev)
        if vdt is None:
            print(f"W={w} stripes={lay.num_stripes} stripe_cols="
                  f"{lay.stripe_cols} pad={lay.padding_ratio:.2f} "
                  f"rank_nb={lay.rank_nb}", file=sys.stderr, flush=True)
        wrong, rel = validate(spmv_striped(lay, x).cpu().numpy(),
                              oracle.matvec(x_np))
        ok = ok and wrong == 0
        key = "rel" if vdt is None else "rel_vs_rounded"
        if not timed:
            print(f"{tag}: platform=cpu wrong={wrong} {key}={rel:.1e} "
                  "(plain versions: no time)", flush=True)
            continue
        warm = bench_spmv(spmv_striped, lay, x, nnz=mat.nnz)
        cold = bench_spmv_cold(spmv_striped, lay.clone, x, nnz=mat.nnz,
                               layout_bytes=lay.nbytes)
        print(f"{tag}: platform=gpu wrong={wrong} {key}={rel:.1e} warm "
              f"gflops={warm.gflops:.2f} gnnzs={warm.vals_per_s / 1e9:.2f} "
              f"time_min={warm.time_min:.6g}s time_avg={warm.time_avg:.6g}s"
              f" | cold (K={cold.iters[2]} copies of "
              f"{lay.nbytes / 2**20:.1f} MB) gflops={cold.gflops:.2f} "
              f"time_min={cold.time_min:.6g}s time_avg={cold.time_avg:.6g}s",
              flush=True)
        del lay
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
