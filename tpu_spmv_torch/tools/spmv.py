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
      [sizes ...]
      [--kernel auto|dia|packed|ranked|sell|striped|segsum|bcoo|dense]
      [--val-dtype f32|bf16] [--rcm auto|always|never] [--bin-blocks W]
      [--sigma S] [--layout-cache PATH.npz] [--cold] [--validate-only]

The planner (tune/model.tpu_plan, on the card's calibration) decides
RCM under `--rcm auto`, the kernel under `--kernel auto`, the column-bin
width W unless `--bin-blocks` is given, and the SELL-C-sigma row sort
unless `--sigma` is given; a sort it recommends is kept only when the
re-plan on the sorted matrix costs less. `--layout-cache` loads a
sell/ranked/packed layout from the .npz when it exists (refusing one of
another matrix or configuration) and writes it after the build
otherwise, in the reference's format, so a cache of either package loads
in the other.

An x past the L2 residency gate (half the L2, hw.l2_bytes) takes the
windowed DIA or ranked kernel, e.g. `synthetic:lap2d_4096` (x 67 MB), or,
for a column-binned ranked layout (`--bin-blocks W`), the column-striped
passes, e.g. `synthetic:scattered_16m --kernel ranked --bin-blocks 64`
(x 64 MB). There `--val-dtype bf16` stores bf16 stripes only where the
card's calibration times them faster than f32 ones (kernels/striped.
bf16_pays); elsewhere the reference's gate stores f32 and says so.
segsum, bcoo and dense are the baselines: library calls (index_add_, a
sparse CSR tensor's matvec, torch.mv), not kernels.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def load_input(spec: str):
    """A CSRMatrix from a `synthetic:<name>` spec (bench/matrices.py) or
    a .csr/.csr2/.csr3/.mtx(.gz) file (tools/stats.load), as
    tpu_spmv.tools.spmv.load_input loads it."""
    if spec.startswith("synthetic:"):
        from tpu_spmv_torch.bench import matrices

        return matrices.make(spec.split(":", 1)[1])
    from tpu_spmv_torch.tools.stats import load

    return load(spec)


def prepare(mat, rcm: str = "auto", k: int = 1, sizes: tuple = (),
            with_plan: bool = False):
    """Reorder as the JAX CLI does: RCM (per `rcm`, or the planner's
    needs_rcm under "auto", square matrices only), then CSR-k.

    Returns (ck, perm): the CSRkMatrix whose `.matrix` the layout is
    built from, and the permutation (new -> old) that x is gathered with
    (and the oracle's y, unless a sigma row sort follows). with_plan
    adds a third item: the plan of ck.matrix when the RCM decision
    planned that very matrix (no RCM, k = 1), else None, so the caller
    need not plan it again.
    """
    from tpu_spmv_torch.formats.csrk import CSRkMatrix
    from tpu_spmv_torch.tune.model import tpu_plan

    work, pre_perm, plan = mat, None, None
    if rcm != "never" and mat.m == mat.n:
        if rcm == "auto":
            plan = tpu_plan(mat)
        if rcm == "always" or plan.needs_rcm:
            from tpu_spmv_torch.reorder import rcm as rcm_fn

            pre_perm = rcm_fn(mat.indptr, mat.indices)
            work = mat.permuted(pre_perm)
            print("RCM applied (converter.m role)")
    ck = CSRkMatrix.build(work, k=k, sup_row_sizes=tuple(sizes))
    perm = ck.perm if pre_perm is None else pre_perm[ck.perm]
    if not with_plan:
        return ck, perm
    return ck, perm, (plan if ck.matrix is mat else None)


class LayoutCache:
    """The CLI's --layout-cache (tpu_spmv/tools/spmv.py:205-233): a
    sell/ranked/packed layout is loaded from `path` when the file exists
    (formats/sell.load_layout, which refuses a cache of another matrix or
    configuration), else built and saved there. The configuration is
    (bin_blocks, sigma, k), plus (1,) for a layout that stores bf16
    values (a sell fallback stores f32, so its cache carries the f32
    key)."""

    def __init__(self, path, matrix, config: tuple, bf16: bool):
        self.path, self.matrix = path, matrix
        self.config, self.bf16 = tuple(config), bf16

    def holds(self) -> str | None:
        """The class name of the layout in the cache, None without one."""
        import os

        if not os.path.exists(self.path):
            return None
        with np.load(self.path, allow_pickle=False) as z:
            return str(z["__class__"])

    def __call__(self, cls, build):
        import os
        import time

        from tpu_spmv_torch.formats.sell import SellSlabs, load_layout

        cfg = self.config + ((1,) if self.bf16 and cls is not SellSlabs
                             else ())
        if os.path.exists(self.path):
            t0 = time.perf_counter()
            lay = load_layout(self.path, matrix=self.matrix, config=cfg)
            if type(lay) is not cls:
                raise SystemExit(f"cached layout is {type(lay).__name__}, "
                                 f"kernel wants {cls.__name__}")
            print(f"loaded layout from {self.path} "
                  f"({time.perf_counter() - t0:.2f} s)")
            return lay
        lay = build()
        lay.save(self.path, matrix=self.matrix, config=cfg)
        print(f"saved layout to {self.path}")
        return lay


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


def striped_val_dtype(val_dtype, refusal: str):
    """The value dtype the column stripes store for a requested
    `val_dtype` (None: f32). bf16 stays only where the card's calibration
    times bf16 stripes faster than f32 ones (kernels/striped.bf16_pays),
    which a line says with the entry's ratio; otherwise `refusal`, the
    reference's message, is printed and the stripes store f32. On an
    NVIDIA H100 80GB HBM3 at 700.00 W, bf16 stripes of scattered_16m took
    1,071-1,072 us against f32's 1,286.6 (bench/scattered_16m.py; W =
    64, P = 6)."""
    from tpu_spmv_torch.kernels.striped import bf16_pays, bf16_ratio

    if val_dtype is None:
        return None
    if bf16_pays():
        print(f"bf16 stripes: this card's calibration times them at "
              f"{bf16_ratio():.4g}x the f32 stripes (striped_bf16); "
              "storing bf16 values")
        return val_dtype
    print(refusal)
    return None


def _striped(matrix, bin_blocks: int, val_dtype, device):
    """The column-striped layout (`val_dtype` values, None: f32), or
    SystemExit with the reference's message when the matrix fits one
    stripe."""
    from tpu_spmv_torch.kernels.striped import StripedRanked

    try:
        return StripedRanked.from_csr(matrix, bin_blocks=bin_blocks,
                                      val_dtype=val_dtype, device=device)
    except ValueError as e:
        raise SystemExit(str(e))


def _striped_route(matrix, bin_blocks: int, val_dtype, device):
    """The ranked route for a column-binned layout whose x is past the
    gate (tpu_spmv/tools/spmv.py:256-276): column-binned windows have no
    band locality for the ring's steps, so x goes through column-stripe
    passes, in bf16 only where striped_val_dtype keeps it."""
    from tpu_spmv_torch.kernels.striped import spmv_striped

    val_dtype = striped_val_dtype(
        val_dtype, "(bf16 gated off on the striped fallback — measured "
        "slower than f32; storing f32)")
    layout = _striped(matrix, bin_blocks, val_dtype, device)
    print(f"x exceeds the L2 residency budget ({x_budget(matrix.n, device)})"
          f"; column-striped passes (P={layout.num_stripes})")
    return layout, spmv_striped, "striped"


def _baseline(matrix, kernel: str, device):
    """(layout, spmv function, kernel) of a baseline library call:
    segsum, bcoo or dense (SystemExit past the dense cap)."""
    if kernel == "segsum":
        from tpu_spmv_torch.kernels.segsum import SegsumLayout, spmv_segsum

        return SegsumLayout.from_csr(matrix, device=device), spmv_segsum, kernel
    if kernel == "bcoo":
        from tpu_spmv_torch.kernels.bcoo import BCOOLayout, spmv_bcoo

        return BCOOLayout.from_csr(matrix, device=device), spmv_bcoo, kernel
    from tpu_spmv_torch.kernels.dense import DenseLayout, spmv_dense

    try:
        layout = DenseLayout.from_csr(matrix, device=device)
    except ValueError as e:
        raise SystemExit(str(e))
    print(f"dense baseline: operator {layout.a.numel() * 4 / 2**20:.1f} MB, "
          f"density {matrix.nnz / max(matrix.m * matrix.n, 1):.2%}")
    return layout, spmv_dense, kernel


def build_layout(matrix, kernel: str, val_dtype=None, bin_blocks: int = 0,
                 device=None, cache=None):
    """(layout on `device`, spmv function, kernel actually used) for
    kernel in dia/packed/ranked/sell/striped or a baseline (segsum, bcoo,
    dense); device defaults to the card (hw.target_device). Routed as
    tpu_spmv/tools/spmv.py routes them: a packed build that exceeds the
    packed-delta range falls back to ranked, and a ranked one to sell,
    each saying so; past the x residency gate (kernels/dia.dia_x_fits,
    kernels/sell.resident_x_fits) dia and ranked take their windowed
    kernels, a column-binned ranked layout takes the column-striped
    passes (bf16 values only where the card's calibration times them
    faster: striped_val_dtype), and sell warns. kernel "striped" stores
    `val_dtype` as given (main applies the gate to it).
    cache: a LayoutCache through which the sell, ranked and packed
    layouts are loaded or built (the striped route builds its own
    stripes); a cache that does not match ends the run (SystemExit)."""
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
    from tpu_spmv_torch.formats.sell import LayoutCacheMismatch
    from tpu_spmv_torch.kernels.striped import spmv_striped
    from tpu_spmv_torch.tune.model import _packed_x_fits

    def get(cls, build):
        try:
            return build() if cache is None else cache(cls, build)
        except LayoutCacheMismatch as e:
            raise SystemExit(str(e))

    device = hw.target_device(device)
    if kernel in ("segsum", "bcoo", "dense"):
        return _baseline(matrix, kernel, device)
    if kernel == "striped":
        layout = _striped(matrix, bin_blocks if bin_blocks > 0 else 16,
                          val_dtype, device)
        print(f"column stripes: P={layout.num_stripes}, "
              f"padding {layout.padding_ratio:.2f}x, "
              f"{str(layout.val_dtype)[6:]} values")
        return layout, spmv_striped, "striped"
    if kernel == "packed" and cache is not None and (
            cache.holds() == "RankedSlabs"):
        # A packed build that fell back to ranked cached the ranked
        # layout; the reference's next run refuses it as the wrong class.
        print(f"{cache.path} holds the ranked fallback of a packed build; "
              "taking the ranked layout")
        kernel = "ranked"
    if kernel == "packed":
        try:
            layout = get(PackedRanked, lambda: PackedRanked.from_csr(
                matrix, val_dtype=val_dtype, bin_blocks=bin_blocks
            ))
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
    if kernel == "ranked" and bin_blocks > 0 and not _packed_x_fits(
            matrix, bin_blocks):
        # x alone is past the gate, so the built layout would be too:
        # no ranked layout is built only to be dropped.
        return _striped_route(matrix, bin_blocks, val_dtype, device)
    if kernel == "ranked":
        try:
            layout = get(RankedSlabs, lambda: RankedSlabs.from_csr(
                matrix, bin_blocks=bin_blocks, val_dtype=val_dtype
            )).to(device)
        except ValueError as e:
            print(f"ranked layout unavailable ({e}); falling back to sell")
            if val_dtype is not None:
                print("(sell fallback stores f32 values; bf16 not applied)")
        else:
            if resident_x_fits(layout):
                return layout, spmv_ranked, "ranked"
            if bin_blocks > 0:
                del layout
                return _striped_route(matrix, bin_blocks, val_dtype, device)
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
    layout = get(SellSlabs, lambda: SellSlabs.from_csr(
        matrix, bin_blocks=bin_blocks)).to(device)
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
        choices=("auto", "sell", "ranked", "packed", "dia", "striped",
                 "segsum", "bcoo", "dense"),
    )
    ap.add_argument("--k", type=int, default=None,
                    help="CSR-k depth; default 1 (plain) or len(sizes)+1")
    ap.add_argument("--tol", type=float, default=0.01)
    ap.add_argument("--rcm", default="auto", choices=("auto", "always", "never"),
                    help="apply RCM before the layout build; 'auto' follows "
                    "the planner's needs_rcm")
    ap.add_argument("--bin-blocks", type=int, default=-1,
                    help="column-bin width in 128-column x blocks for the "
                    "packed/ranked/sell layouts; -1 = follow the planner, "
                    "0 = cluster-aligned slots")
    ap.add_argument("--sigma", type=int, default=-1,
                    help="SELL-C-sigma window: sort rows by descending "
                    "length within windows of this many rows before the "
                    "layout build; -1 = follow the planner, 0 = off")
    ap.add_argument("--val-dtype", default="f32", choices=("f32", "bf16"),
                    help="value storage (packed/ranked/dia; the column "
                    "stripes only where the card's calibration times bf16 "
                    "stripes faster than f32, else f32 with the reference's "
                    "message). bf16 runs are validated against the "
                    "bf16-rounded operator, with drift against the f32 "
                    "oracle printed for information")
    ap.add_argument("--cold", action="store_true",
                    help="time the cold regime: rotate distinct operator "
                    "copies (>= 4x L2 in all) so each launch streams its "
                    "operator from HBM; the default warm regime reuses one "
                    "operator, which may stay in L2")
    ap.add_argument("--validate-only", action="store_true",
                    help="skip the timed benchmark")
    ap.add_argument("--layout-cache", default=None,
                    help="path to a .npz layout (sell/ranked/packed): "
                    "loaded when it exists, written after the build "
                    "otherwise; the matrix is still loaded to validate")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu runs the plain PyTorch versions and needs "
                    "--validate-only")
    args = ap.parse_args(argv)

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
    from tpu_spmv_torch.tune.model import tpu_plan

    mat = load_input(args.input)
    k = args.k if args.k is not None else (len(args.sizes) + 1 if args.sizes else 1)
    sizes = tuple(args.sizes) if args.sizes else tuple([16] * (k - 1))
    ck, perm, rcm_plan = prepare(mat, args.rcm, k, sizes, with_plan=True)
    print(f"k={k} sizes={list(sizes)} rows={mat.m} nnz={mat.nnz}")
    # x is gathered with perm (columns); the oracle's y with out_perm
    # (rows), which a sigma row sort extends.
    out_perm = perm

    # One planner pass serves sigma, the auto kernel and the bin width.
    kernel, bin_blocks, sigma = args.kernel, args.bin_blocks, args.sigma
    plan = None
    if kernel == "auto" or sigma < 0 or (kernel == "ranked" and bin_blocks < 0):
        plan = rcm_plan or tpu_plan(ck.matrix, assume_rcm=(k > 1))
    if sigma < 0:
        sigma = plan.sigma
        if sigma:
            print(f"planner recommends sigma={sigma}")
    if sigma:
        from tpu_spmv_torch.formats.sell import sigma_sort

        sorted_mat, sperm = sigma_sort(ck.matrix, sigma)
        # The sort changes the chunks, so re-plan on the sorted matrix;
        # a recommended sort is kept only when the re-plan costs less, a
        # sort the user asked for always.
        plan_s = (tpu_plan(sorted_mat, assume_rcm=(k > 1))
                  if plan is not None else None)
        if args.sigma >= 0 or plan is None or plan_s.est_cost < plan.est_cost:
            ck = type(ck)(matrix=sorted_mat, perm=ck.perm, maps=ck.maps,
                          k=ck.k, sup_row_sizes=ck.sup_row_sizes)
            out_perm = out_perm[sperm]
            plan = plan_s if plan_s is not None else plan
            print(f"sigma={sigma} row sort applied")
        else:
            print(f"sigma={sigma} rejected after re-plan "
                  f"({plan_s.est_cost:.0f} >= {plan.est_cost:.0f})")

    if kernel == "auto":
        kernel = plan.kernel
        print(f"auto kernel: {kernel} ({plan.reason})")
    if bin_blocks < 0:
        bin_blocks = (plan.bin_blocks
                      if plan and kernel in ("ranked", "sell", "packed") else 0)
        if bin_blocks:
            print(f"planner bin width: W={bin_blocks} blocks")
    vdt = torch.bfloat16 if args.val_dtype == "bf16" else None
    if kernel == "striped":
        # The reference gates bf16 off here on its own chip's timing
        # (tpu_spmv/tools/spmv.py:187-198); the port asks the card's.
        vdt = striped_val_dtype(
            vdt, "--val-dtype bf16 is gated OFF for the striped kernel "
            "(measured slower than f32); storing f32 values")
    if vdt is not None and kernel not in ("packed", "ranked", "dia",
                                          "striped"):
        raise SystemExit(
            "--val-dtype bf16 supports the packed/ranked/dia kernels, not "
            f"{kernel!r}"
        )

    cache = (None if args.layout_cache is None else LayoutCache(
        args.layout_cache, ck.matrix, (bin_blocks, sigma, k), vdt is not None))
    layout, fn, kernel = build_layout(ck.matrix, kernel, vdt, bin_blocks,
                                      device, cache)
    x = np.random.default_rng(0).standard_normal(mat.n).astype(np.float32)
    # The permutation relabels columns with rows only on a square matrix;
    # a rectangular one is never reordered (prepare), so its x is not
    # gathered with the m-long row permutation.
    xt = torch.from_numpy(x[perm] if mat.m == mat.n else x).to(device)
    y = fn(layout, xt).cpu().numpy()

    # bf16 applies to the layout actually built (a sell fallback or gated
    # stripes store f32 and are judged against the f32 oracle).
    stored = getattr(layout, "val_dtype", None) or getattr(
        getattr(layout, "vals", None), "dtype", None)
    if stored == torch.bfloat16:
        wrong, rel = validate(y, mat.rounded().matvec(x)[out_perm],
                              tol=args.tol)
        y_f32 = mat.matvec(x)[out_perm]
        drift = np.linalg.norm(y - y_f32) / max(np.linalg.norm(y_f32), 1e-30)
        print(f"(bf16 values: validated vs the bf16-rounded operator; "
              f"RelL2 vs the f32 oracle = {drift:.2e})")
    else:
        wrong, rel = validate(y, mat.matvec(x)[out_perm], tol=args.tol)
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
