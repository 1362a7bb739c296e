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

An x past the L2 residency gate (half the L2, hw.l2_bytes) takes the
windowed DIA or ranked kernel, e.g. `synthetic:lap2d_4096` (x 67 MB).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def load_input(spec: str):
    """A CSRMatrix from a `synthetic:<name>` spec (bench/matrices.py) or
    a .csr/.csr2/.csr3/.mtx(.gz) file: tpu_spmv.tools.spmv.load_input
    with the file branch of tpu_spmv.tools.stats.load."""
    if spec.startswith("synthetic:"):
        from tpu_spmv_torch.bench import matrices

        return matrices.make(spec.split(":", 1)[1])
    from tpu_spmv_torch.io import (
        read_csr2_text, read_csr3_text, read_csr_text, read_mtx,
    )

    if spec.endswith(".csr3"):
        return read_csr3_text(spec)[0]
    if spec.endswith(".csr2"):
        return read_csr2_text(spec)[0]
    if spec.endswith(".mtx") or spec.endswith(".mtx.gz"):
        return read_mtx(spec)
    return read_csr_text(spec)


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
    from tpu_spmv_torch.formats.csrk import CSRkMatrix

    from tpu_spmv_torch.tune.plan import gpu_plan

    work, pre_perm = mat, None
    if rcm != "never" and mat.m == mat.n:
        apply_rcm = rcm == "always" or gpu_plan(mat).needs_rcm
        if apply_rcm:
            from tpu_spmv_torch.reorder import rcm as rcm_fn

            pre_perm = rcm_fn(mat.indptr, mat.indices)
            work = mat.permuted(pre_perm)
            print("RCM applied (converter.m role)")
    ck = CSRkMatrix.build(work, k=k, sup_row_sizes=tuple(sizes))
    return ck, (ck.perm if pre_perm is None else pre_perm[ck.perm])


def x_budget(n: int, device, batch: int = 1) -> str:
    """What the residency gates weigh, for the CLIs' route messages."""
    from tpu_spmv_torch import hw

    x_mb = 4 * n * batch / 2**20
    return (f"{'X' if batch > 1 else 'x'} {x_mb:.1f} MB against half of the "
            f"{hw.l2_bytes(device) / 2**20:.0f} MB L2")


def fit_window(layout, batch: int, device):
    """(layout, B'): the windowed kernels' ring of x blocks
    (kernels/sell.window_bytes), `batch` columns wide, held to the shared
    memory of one block (hw.smem_per_block). While it does not fit, the
    window table is cut anew at half its step (RankedSlabs.with_steps),
    down to one sub-tile a step: the ring does not depend on the layout's
    tile, so the layout itself is not rebuilt. Then the columns are split
    into passes of B' (halved while the ring still does not fit). Raises
    ValueError, naming the sizes, when B' = 1 at one sub-tile a step
    cannot fit (tpu_spmv/tools/spmm.py:133-176's steps, against shared
    memory in place of the VMEM scratch)."""
    from tpu_spmv_torch import hw
    from tpu_spmv_torch.kernels.sell import window_bytes

    budget = hw.smem_per_block(device)
    while window_bytes(layout, batch) > budget and layout.step_subtiles > 1:
        q = layout.step_subtiles // 2
        print(f"cutting the window table at {q} sub-tile(s) a step: ring "
              f"{layout.ring_blocks} blocks x {batch} column(s) = "
              f"{window_bytes(layout, batch) / 1024:.0f} KB > "
              f"{budget / 1024:.0f} KB of shared memory")
        layout = layout.with_steps(q)
    cols = batch
    while cols > 1 and window_bytes(layout, cols) > budget:
        cols = (cols + 1) // 2
    if window_bytes(layout, cols) > budget:
        raise ValueError(
            f"the x ring is {layout.ring_blocks} blocks "
            f"({window_bytes(layout) / 1024:.0f} KB at one column, "
            f"{layout.step_subtiles} sub-tile(s) a step), beyond the "
            f"{budget / 1024:.0f} KB shared-memory budget"
        )
    return layout, cols


def build_layout(matrix, kernel: str, val_dtype=None, bin_blocks: int = 0,
                 device=None):
    """(layout on `device`, spmv function, kernel actually used) for
    kernel in dia/packed/ranked/sell; device defaults to the card
    (hw.target_device). Routed as tpu_spmv/tools/spmv.py
    routes them: a packed build that exceeds the packed-delta range
    falls back to ranked, and a ranked one to sell, each saying so; past
    the x residency gate (kernels/dia.dia_x_fits, kernels/sell.
    resident_x_fits) dia and ranked take their windowed kernels, a
    column-binned ranked layout is refused (its route, the striped
    kernel, is not ported), and sell warns."""
    from tpu_spmv_torch import hw
    from tpu_spmv_torch.formats.dia import DiaSlabs
    from tpu_spmv_torch.formats.packed import PackedRanked
    from tpu_spmv_torch.formats.sell import RankedSlabs, SellSlabs
    from tpu_spmv_torch.kernels.dia import (
        dia_ring, dia_smem_budget, dia_x_fits, spmv_dia, spmv_dia_windowed,
    )
    from tpu_spmv_torch.kernels.packed import spmv_packed
    from tpu_spmv_torch.kernels.sell import (
        resident_x_fits, spmv_ranked, spmv_ranked_windowed, spmv_sell,
        window_bytes,
    )

    device = hw.target_device(device)
    if kernel == "packed":
        try:
            layout = PackedRanked.from_csr(
                matrix, val_dtype=val_dtype, bin_blocks=bin_blocks
            )
            print(f"packed mixed-height slabs: pad "
                  f"{layout.padding_ratio:.2f}x, rank {layout.rank_nb}"
                  + (f", W={bin_blocks} bins" if bin_blocks > 0 else ""))
            return layout.to(device), spmv_packed, "packed"
        except ValueError as e:
            print(f"packed layout unavailable ({e}); falling back to ranked")
            kernel = "ranked"
    if kernel == "dia":
        layout = DiaSlabs.from_csr(matrix, val_dtype=val_dtype).to(device)
        print(f"DIA: {layout.num_diagonals} diagonals, "
              f"fill {layout.padding_ratio:.2f}x")
        if dia_x_fits(layout):
            return layout, spmv_dia, "dia"
        ring = dia_ring(layout, dia_smem_budget(device))
        print(f"x exceeds the L2 residency budget ({x_budget(matrix.n, device)}"
              f"); using the HBM-windowed DIA kernel: steps of "
              f"{ring.step_rows} rows, a ring of {ring.ring} floats of x, "
              f"{ring.smem} bytes of shared memory a CTA")
        return layout, spmv_dia_windowed, "dia"
    if kernel == "ranked":
        try:
            layout = RankedSlabs.from_csr(
                matrix, bin_blocks=bin_blocks, val_dtype=val_dtype
            ).to(device)
        except ValueError as e:
            print(f"ranked layout unavailable ({e}); falling back to sell")
            if val_dtype is not None:
                print("(sell fallback stores f32 values; bf16 not applied)")
        else:
            if resident_x_fits(layout):
                return layout, spmv_ranked, "ranked"
            if bin_blocks > 0:
                raise SystemExit(
                    f"x exceeds the L2 residency budget "
                    f"({x_budget(matrix.n, device)}) and the column-binned "
                    f"layout (W={bin_blocks}) has no windowed route: its "
                    "column-striped passes are not ported to the GPU yet "
                    f"(ROADMAP.md item {REFUSED_KERNELS['striped']})"
                )
            try:
                layout, _ = fit_window(layout, 1, device)
            except ValueError as e:
                raise SystemExit(
                    f"no windowed SpMV path: {e}. Use --kernel packed or "
                    "--kernel sell, which gather x from device memory"
                )
            print(f"x exceeds the L2 residency budget ({x_budget(matrix.n, device)}"
                  f"); using the HBM-windowed kernel: ring "
                  f"{layout.ring_blocks} blocks "
                  f"({window_bytes(layout) / 1024:.0f} KB of shared memory), "
                  f"{layout.step_lo.numel()} steps of "
                  f"{layout.step_subtiles} sub-tile(s)")
            return layout, spmv_ranked_windowed, "ranked"
    layout = SellSlabs.from_csr(matrix, bin_blocks=bin_blocks).to(device)
    if not resident_x_fits(layout):
        print(f"warning: x exceeds the L2 residency budget "
              f"({x_budget(matrix.n, device)}) and the sell kernel has no "
              "windowed variant: its gathers read x from device memory; "
              "--kernel ranked takes the windowed route")
    return layout, spmv_sell, "sell"


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

    layout, fn, kernel = build_layout(ck.matrix, kernel, vdt, bin_blocks,
                                      device)
    x = np.random.default_rng(0).standard_normal(mat.n).astype(np.float32)
    xt = torch.from_numpy(x[perm]).to(device)
    y = fn(layout, xt).cpu().numpy()

    # bf16 applies to the layout actually built (a sell fallback stores
    # f32 and is judged against the f32 oracle).
    if layout.vals.dtype == torch.bfloat16:
        wrong, rel = validate(y, mat.rounded().matvec(x)[perm], tol=args.tol)
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
