"""SpMV benchmark CLI of the port: load, reorder, plan, build, run,
validate and time y = A @ x on a CUDA card.

Counterpart of `python -m tpu_spmv.tools.spmv`, with its flags and
output keys (`RCM applied`, `auto kernel:`, TimeMin/TimeMax/TimeAvg/
GFLOPs, `nnz/s ... (% of roofline)`, `Number Wrong:`, `RelL2:`).
Timing runs on the card with CUDA events (bench/harness.py) and says
which regime it measured. `--device cpu` runs the plain PyTorch
versions and is accepted only with `--validate-only`.

Usage:
  python -m tpu_spmv_torch.tools.spmv matrix.mtx|synthetic:NAME [num_runs]
      [sizes ...] [--kernel auto|dia|packed|ranked|sell]
      [--val-dtype f32|bf16]
      [--rcm auto|always|never] [--bin-blocks W] [--cold] [--validate-only]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

# A file path or `synthetic:<name>` -> CSRMatrix (JAX-free at import).
from tpu_spmv.tools.spmv import load_input

# Options of the JAX CLI that the port does not run yet, and the
# ROADMAP.md queue-A item that ports each.
REFUSED_KERNELS = {
    "striped": "A10 (column stripes)",
    "segsum": "A5 (baselines)",
    "bcoo": "A5 (baselines)",
    "dense": "A5 (baselines)",
}
REFUSED_SIGMA = "A6 (planner: SELL-C-sigma row sort)"
REFUSED_LAYOUT_CACHE = "A7 (CLIs: layout cache)"


def prepare(mat, rcm: str = "auto", k: int = 1, sizes: tuple = ()):
    """Reorder as the JAX CLI does: RCM (per `rcm`, or the planner's
    needs_rcm under "auto", square matrices only), then CSR-k.

    Returns (ck, perm): the CSRkMatrix whose `.matrix` the layout is
    built from, and the permutation (new -> old) that both x and the
    oracle's y are gathered with (the port has no row-only sort, which
    is what made the JAX CLI keep two).
    """
    from tpu_spmv.formats.csrk import CSRkMatrix

    from tpu_spmv_torch.tune.plan import gpu_plan

    work, pre_perm = mat, None
    if rcm != "never" and mat.m == mat.n:
        apply_rcm = rcm == "always" or gpu_plan(mat).needs_rcm
        if apply_rcm:
            from tpu_spmv.reorder import rcm as rcm_fn

            pre_perm = rcm_fn(mat.indptr, mat.indices)
            work = mat.permuted(pre_perm)
            print("RCM applied (converter.m role)")
    ck = CSRkMatrix.build(work, k=k, sup_row_sizes=tuple(sizes))
    return ck, (ck.perm if pre_perm is None else pre_perm[ck.perm])


def build_layout(matrix, kernel: str, val_dtype=None, bin_blocks: int = 0):
    """(layout, spmv function, kernel actually used) for kernel in
    dia/packed/ranked/sell. A packed build that exceeds the packed-delta
    range falls back to ranked, and a ranked one to sell, each saying
    so (tpu_spmv/tools/spmv.py's fallbacks)."""
    from tpu_spmv_torch.formats.dia import DiaSlabs
    from tpu_spmv_torch.formats.packed import PackedRanked
    from tpu_spmv_torch.formats.sell import RankedSlabs, SellSlabs
    from tpu_spmv_torch.kernels.dia import spmv_dia
    from tpu_spmv_torch.kernels.packed import spmv_packed
    from tpu_spmv_torch.kernels.sell import spmv_ranked, spmv_sell

    if kernel == "packed":
        try:
            layout = PackedRanked.from_csr(
                matrix, val_dtype=val_dtype, bin_blocks=bin_blocks
            )
            print(f"packed mixed-height slabs: pad "
                  f"{layout.padding_ratio:.2f}x, rank {layout.rank_nb}"
                  + (f", W={bin_blocks} bins" if bin_blocks > 0 else ""))
            return layout, spmv_packed, "packed"
        except ValueError as e:
            print(f"packed layout unavailable ({e}); falling back to ranked")
            kernel = "ranked"
    if kernel == "dia":
        layout = DiaSlabs.from_csr(matrix, val_dtype=val_dtype)
        print(f"DIA: {layout.num_diagonals} diagonals, "
              f"fill {layout.padding_ratio:.2f}x")
        return layout, spmv_dia, "dia"
    if kernel == "ranked":
        try:
            layout = RankedSlabs.from_csr(
                matrix, bin_blocks=bin_blocks, val_dtype=val_dtype
            )
            return layout, spmv_ranked, "ranked"
        except ValueError as e:
            print(f"ranked layout unavailable ({e}); falling back to sell")
            if val_dtype is not None:
                print("(sell fallback stores f32 values; bf16 not applied)")
    return SellSlabs.from_csr(matrix, bin_blocks=bin_blocks), spmv_sell, "sell"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", help=".csr/.csr3/.mtx file, or synthetic:<name>")
    ap.add_argument("num_runs", nargs="?", type=int, default=20,
                    help="timed samples (each of enough back-to-back "
                    "launches to last ~20 ms)")
    ap.add_argument("sizes", nargs="*", type=int,
                    help="super-row sizes per level (k-1 of them)")
    ap.add_argument(
        "--kernel", default="auto",
        choices=("auto", "sell", "ranked", "packed", "dia", *REFUSED_KERNELS),
    )
    ap.add_argument("--k", type=int, default=None,
                    help="CSR-k depth; default 1 (plain) or len(sizes)+1")
    ap.add_argument("--tol", type=float, default=0.01)
    ap.add_argument("--rcm", default="auto", choices=("auto", "always", "never"),
                    help="apply RCM before the layout build; 'auto' follows "
                    "the planner's needs_rcm")
    ap.add_argument("--bin-blocks", type=int, default=-1,
                    help="column-bin width in 128-column x blocks for the "
                    "packed/ranked/sell layouts; -1 = planner (0), 0 = "
                    "cluster-aligned slots")
    ap.add_argument("--sigma", type=int, default=-1,
                    help="SELL-C-sigma row sort window (not ported yet: "
                    "a positive window is refused)")
    ap.add_argument("--val-dtype", default="f32", choices=("f32", "bf16"),
                    help="value storage (packed/ranked/dia). bf16 runs are "
                    "validated against the bf16-rounded operator, with "
                    "drift against the f32 oracle printed for information")
    ap.add_argument("--cold", action="store_true",
                    help="time the cold regime: rotate distinct operator "
                    "copies (>= 4x L2 in all) so each launch streams its "
                    "operator from HBM; the default warm regime reuses one "
                    "operator, which may stay in L2")
    ap.add_argument("--validate-only", action="store_true",
                    help="skip the timed benchmark")
    ap.add_argument("--layout-cache", default=None,
                    help="not ported yet: refused")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu runs the plain PyTorch versions and needs "
                    "--validate-only")
    args = ap.parse_args(argv)

    if args.kernel in REFUSED_KERNELS:
        raise SystemExit(
            f"--kernel {args.kernel} is not ported to the GPU yet "
            f"(ROADMAP.md item {REFUSED_KERNELS[args.kernel]})"
        )
    if args.sigma > 0:
        raise SystemExit(
            f"--sigma is not ported to the GPU yet (ROADMAP.md item "
            f"{REFUSED_SIGMA})"
        )
    if args.layout_cache is not None:
        raise SystemExit(
            f"--layout-cache is not ported to the GPU yet (ROADMAP.md "
            f"item {REFUSED_LAYOUT_CACHE})"
        )
    device = torch.device(args.device)
    if device.type == "cpu" and not args.validate_only:
        raise SystemExit(
            "--device cpu runs only with --validate-only: timing needs a "
            "CUDA card"
        )
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "no CUDA device: the port runs on a CUDA card (use --device "
            "cpu --validate-only for a CPU check)"
        )

    from tpu_spmv_torch.bench.harness import validate
    from tpu_spmv_torch.formats.convert import rounded
    from tpu_spmv_torch.tune.plan import gpu_plan

    mat = load_input(args.input)
    k = args.k if args.k is not None else (len(args.sizes) + 1 if args.sizes else 1)
    sizes = tuple(args.sizes) if args.sizes else tuple([16] * (k - 1))
    ck, perm = prepare(mat, args.rcm, k, sizes)
    print(f"k={k} sizes={list(sizes)} rows={mat.m} nnz={mat.nnz}")

    kernel = args.kernel
    if kernel == "auto":
        plan = gpu_plan(ck.matrix, assume_rcm=(k > 1))
        kernel = plan.kernel
        print(f"auto kernel: {kernel} ({plan.reason})")
        bin_blocks = plan.bin_blocks if args.bin_blocks < 0 else args.bin_blocks
    else:
        bin_blocks = max(args.bin_blocks, 0)
    vdt = torch.bfloat16 if args.val_dtype == "bf16" else None
    if vdt is not None and kernel not in ("packed", "ranked", "dia"):
        raise SystemExit(
            "--val-dtype bf16 supports the packed/ranked/dia kernels, not "
            f"{kernel!r}"
        )

    layout, fn, kernel = build_layout(ck.matrix, kernel, vdt, bin_blocks)
    layout = layout.to(device)
    x = np.random.default_rng(0).standard_normal(mat.n).astype(np.float32)
    xt = torch.from_numpy(x[perm]).to(device)
    y = fn(layout, xt).cpu().numpy()

    # bf16 applies to the layout actually built (a sell fallback stores
    # f32 and is judged against the f32 oracle).
    if layout.vals.dtype == torch.bfloat16:
        wrong, rel = validate(y, rounded(mat).matvec(x)[perm], tol=args.tol)
        y_f32 = mat.matvec(x)[perm]
        drift = np.linalg.norm(y - y_f32) / max(np.linalg.norm(y_f32), 1e-30)
        print(f"(bf16 values: validated vs the bf16-rounded operator; "
              f"RelL2 vs the f32 oracle = {drift:.2e})")
    else:
        wrong, rel = validate(y, mat.matvec(x)[perm], tol=args.tol)
        if vdt is not None:
            print("(--val-dtype bf16 requested but the built layout "
                  "stores f32; validated vs the f32 oracle)")
    if args.validate_only:
        print(f"Number Wrong: {wrong} ")
        print(f"RelL2: {rel:.3g}")
        return 0 if wrong == 0 else 1

    from tpu_spmv_torch.bench.harness import (
        bench_spmv, bench_spmv_cold, roofline_nnzs,
    )
    from tpu_spmv_torch.hw import device_spec

    samples = max(args.num_runs, 1)
    if args.cold:
        lbytes = layout.nbytes
        res = bench_spmv_cold(fn, layout.clone, xt, nnz=mat.nnz,
                              layout_bytes=lbytes, samples=samples)
        print(f"cold regime: operator streamed from HBM "
              f"({lbytes / 2**20:.1f} MB/copy, K={res.iters[2]} copies)")
        bytes_per_nnz = lbytes / max(mat.nnz, 1)
    else:
        res = bench_spmv(fn, layout, xt, samples=samples)
        print("warm regime: one operator reused every launch (it may stay "
              f"in the {device_spec().l2_bytes / 2**20:.0f} MB L2)")
        bytes_per_nnz = layout.hbm_bytes / max(mat.nnz, 1)
    print(res.summary(), end="")
    roof = roofline_nnzs(bytes_per_nnz)
    # Cold rows use TimeAvg (the steady streaming rate), warm rows the
    # reference's TimeMin convention.
    t_rep = res.time_avg if args.cold else res.time_min
    nnzs = mat.nnz / t_rep
    print(f"nnz/s: {nnzs:.4g} ({100 * nnzs / roof:.0f}% of roofline)")
    print(f"Number Wrong: {wrong} ")
    print(f"RelL2: {rel:.3g}")
    return 0 if wrong == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
