"""Parameter and benchmark sweep on the card (the port of
`tpu_spmv.tools.sweep`, the reference runners' role).

Iterates kernels x matrices x super-row sizes, runs each configuration
through the port's kernels, validates it against the serial oracle and
times it (bench/harness.bench_spmv: warm TimeMin, CUDA graph), and
appends one CSV row each with the reference's columns (CSV_FIELDS), so
rows from both packages compare. The CSV is opened in append mode and a
row already present (matrix, kernel, k, srs) is skipped, so an
interrupted sweep resumes.

Matrices are synthetic suite names (bench/matrices.suite_factories at
--scale) or file paths and globs (.mtx/.mtx.gz/.csr/.csr2/.csr3),
keyed parent/name. Kernels: sell, ranked, dia, striped, packed (a
packed-delta overflow runs ranked and is keyed packed>ranked), the
baselines bcoo, dense and segsum (library calls), and auto (the
planner's kernel and bin width, after its recommended SELL-C-sigma sort
when the re-plan costs less).

`--device cpu` runs the plain PyTorch versions and leaves the time
columns (time_*, gflops, gnnzs) empty: a host time is not the card's.

Usage:
  python -m tpu_spmv_torch.tools.sweep --out results.csv \\
      --matrices lap2d_256 'data/rcm/*.csr' --kernels ranked segsum \\
      --srs 8 16 32 64
"""

from __future__ import annotations

import argparse
import csv
import pathlib
import sys
import traceback

import numpy as np
import torch

CSV_FIELDS = [
    "matrix", "kernel", "k", "srs", "rows", "nnz",
    "time_min", "time_max", "time_avg", "gflops", "gnnzs",
    "num_wrong", "rel_l2", "pad_ratio", "max_nb", "bin_blocks",
]


def _resolve_matrices(entries, suite: dict):
    """Yield (name, loader) pairs from suite names, file paths, globs."""
    import glob as globmod

    from tpu_spmv_torch.tools.stats import load

    for entry in entries:
        if entry in suite:
            yield entry, suite[entry]  # zero-arg factory, built lazily
            continue
        paths = sorted(globmod.glob(entry)) or [entry]
        for p in paths:
            pp = pathlib.Path(p)
            if not pp.exists():
                raise SystemExit(
                    f"matrix {entry!r}: not a suite name "
                    f"({', '.join(sorted(suite))}) and no such file"
                )
            # Parent-qualified, so norm/a.csr and rcm/a.csr stay apart.
            name = (
                f"{pp.parent.name}/{pp.name}" if pp.parent.name else pp.name
            )
            yield name, (lambda q=p: load(q))


def _done_keys(path: pathlib.Path) -> set:
    if not path.exists():
        return set()
    with open(path) as f:
        reader = csv.DictReader(f)
        if reader.fieldnames and list(reader.fieldnames) != CSV_FIELDS:
            raise SystemExit(
                f"{path}: existing CSV header {reader.fieldnames} does not "
                f"match the current schema {CSV_FIELDS}; resuming would "
                "append misaligned rows — use a new --out file"
            )
        return {
            (r["matrix"], r["kernel"], r["k"], r["srs"])
            for r in reader
        }


def _layout(kern: str, mat, bb: int, vdt, device):
    """(layout on device, spmv function, pad, max_nb, ran) of one sweep
    kernel; ran is "packed>ranked" when a packed build fell back."""
    from tpu_spmv_torch.formats.packed import PackedRanked
    from tpu_spmv_torch.formats.sell import RankedSlabs, SellSlabs
    from tpu_spmv_torch.kernels.sell import spmv_ranked, spmv_sell

    if kern == "sell":
        lay = SellSlabs.from_csr(mat, bin_blocks=bb)
        return lay.to(device), spmv_sell, lay.padding_ratio, lay.max_nb, kern
    if kern == "ranked":
        lay = RankedSlabs.from_csr(mat, bin_blocks=bb, val_dtype=vdt)
        return (lay.to(device), spmv_ranked, lay.padding_ratio, lay.rank_nb,
                kern)
    if kern == "dia":
        from tpu_spmv_torch.formats.dia import DiaSlabs
        from tpu_spmv_torch.kernels.dia import spmv_dia

        lay = DiaSlabs.from_csr(mat, val_dtype=vdt)
        return (lay.to(device), spmv_dia, lay.padding_ratio,
                lay.num_diagonals, kern)
    if kern == "striped":
        from tpu_spmv_torch.kernels.striped import StripedRanked, spmv_striped

        lay = StripedRanked.from_csr(mat, bin_blocks=bb if bb > 0 else 16,
                                     val_dtype=vdt, device=device)
        return lay, spmv_striped, lay.padding_ratio, lay.rank_nb, kern
    if kern == "packed":
        from tpu_spmv_torch.kernels.packed import spmv_packed

        try:
            lay = PackedRanked.from_csr(mat, val_dtype=vdt,
                                        bin_blocks=max(bb, 0))
            fn, ran = spmv_packed, kern
        except ValueError:
            # Packed-delta overflow: the quantized ranked layout, and the
            # row says which kernel ran.
            lay = RankedSlabs.from_csr(mat, bin_blocks=bb, val_dtype=vdt)
            fn, ran = spmv_ranked, "packed>ranked"
        return lay.to(device), fn, lay.padding_ratio, lay.rank_nb, ran
    if kern == "bcoo":
        from tpu_spmv_torch.kernels.bcoo import BCOOLayout, spmv_bcoo

        return BCOOLayout.from_csr(mat, device=device), spmv_bcoo, 1.0, 0, kern
    if kern == "dense":
        from tpu_spmv_torch.kernels.dense import DenseLayout, spmv_dense

        # pad: the densification blow-up (the datum).
        return (DenseLayout.from_csr(mat, device=device), spmv_dense,
                mat.m * mat.n / max(mat.nnz, 1), 0, kern)
    from tpu_spmv_torch.kernels.segsum import SegsumLayout, spmv_segsum

    return (SegsumLayout.from_csr(mat, device=device), spmv_segsum, 1.0, 0,
            kern)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="sweep.csv")
    ap.add_argument("--scale", default="small",
                    choices=("tiny", "small", "bench"))
    ap.add_argument("--matrices", nargs="*", default=None)
    ap.add_argument("--kernels", nargs="*", default=["sell", "segsum"])
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--rcm", nargs="?", const="always", default="never",
                    choices=("always", "never", "auto"),
                    help="RCM-reorder each matrix before the CSR-k build; "
                    "'auto' follows the planner's needs_rcm (stencils stay "
                    "in natural order, so auto can pick DIA); bare --rcm = "
                    "always")
    ap.add_argument("--srs", nargs="*", type=int,
                    default=[8, 16, 24, 32, 48, 64, 96, 128],
                    help="super-row size grid (reference grid run_epyc.py:24)")
    ap.add_argument("--bin-blocks", type=int, default=-1,
                    help="column-bin width (x blocks) for manual "
                    "ranked/packed/sell rows; -1 = the plan's for auto "
                    "rows, 0 (aligned slots) for manual kernels")
    ap.add_argument("--val-dtype", default="f32", choices=("f32", "bf16"),
                    help="value storage for the ranked/packed/striped/dia "
                    "kernels (bf16 rows are keyed '<kernel>+bf16' and "
                    "validated against the bf16-rounded operator)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu runs the plain PyTorch versions and leaves "
                    "the time columns empty")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "no CUDA device: the sweep times the card (use --device cpu to "
            "validate only)"
        )

    from tpu_spmv_torch.bench import matrices as M
    from tpu_spmv_torch.bench.harness import bench_spmv, validate
    from tpu_spmv_torch.formats.csrk import CSRkMatrix

    vdt = torch.bfloat16 if args.val_dtype == "bf16" else None
    if vdt is not None:
        bad = set(args.kernels) - {"ranked", "packed", "striped", "dia"}
        if bad:
            raise SystemExit(
                f"--val-dtype bf16 supports ranked/packed/striped/dia "
                f"sweep kernels, not {sorted(bad)}"
            )

    suite = M.suite_factories(args.scale)
    entries = args.matrices or list(suite)
    out = pathlib.Path(args.out)
    done = _done_keys(out)
    new_file = not out.exists()
    with open(out, "a", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=CSV_FIELDS)
        if new_file:
            writer.writeheader()
        for name, loader in _resolve_matrices(entries, suite):
            mat = loader()
            rcm_applied = args.rcm == "always"
            if args.rcm == "auto" and mat.m == mat.n:
                from tpu_spmv_torch.tune.model import tpu_plan

                rcm_applied = tpu_plan(mat).needs_rcm
                if not rcm_applied:
                    print(f"{name}: planner keeps natural order")
            if rcm_applied:
                from tpu_spmv_torch.reorder import rcm as rcm_fn

                mat = mat.permuted(rcm_fn(mat.indptr, mat.indices))
            x = np.random.default_rng(0).standard_normal(mat.n).astype(
                np.float32)
            # The oracle depends only on (matrix, dtype, x).
            mat_v = mat if vdt is None else mat.rounded(vdt)
            y_ref_full = mat_v.matvec(x)
            for kernel in args.kernels:
                kname = kernel if vdt is None else f"{kernel}+bf16"
                for srs in args.srs:
                    key = (name, kname, str(args.k), str(srs))
                    key_fb = (
                        name, kname.replace("packed", "packed>ranked"),
                        str(args.k), str(srs),
                    )
                    if key in done or key_fb in done:
                        continue
                    try:
                        ck = CSRkMatrix.build(
                            mat, k=args.k,
                            sup_row_sizes=(srs,) * max(args.k - 1, 0),
                        )
                        xt = torch.from_numpy(ck.set_x(x)).to(device)
                        kern, bb = kernel, max(args.bin_blocks, 0)
                        mat_l, vperm = ck.matrix, ck.perm
                        if kern == "auto":
                            from tpu_spmv_torch.formats.sell import (
                                sigma_sort,
                            )
                            from tpu_spmv_torch.tune.model import tpu_plan

                            plan = tpu_plan(ck.matrix, assume_rcm=rcm_applied)
                            if plan.sigma:
                                # The recommended row sort (rows only:
                                # x is unaffected), kept when the
                                # re-plan on the sorted matrix costs
                                # less.
                                mat_s, sperm = sigma_sort(
                                    ck.matrix, plan.sigma
                                )
                                plan_s = tpu_plan(mat_s,
                                                  assume_rcm=rcm_applied)
                                if plan_s.est_cost < plan.est_cost:
                                    mat_l, plan = mat_s, plan_s
                                    vperm = ck.perm[sperm]
                            kern, bb = plan.kernel, plan.bin_blocks
                        lay, fn, pad, nb, ran = _layout(kern, mat_l, bb, vdt,
                                                        device)
                        kname_row = (kname if ran == kern
                                     else kname.replace("packed", ran))
                        y = fn(lay, xt).cpu().numpy()
                        wrong, rel = validate(y, y_ref_full[vperm])
                        times = dict.fromkeys(
                            ("time_min", "time_max", "time_avg", "gflops",
                             "gnnzs"), "")
                        if device.type == "cuda":
                            r = bench_spmv(fn, lay, xt, nnz=mat.nnz)
                            times = {
                                "time_min": f"{r.time_min:.6g}",
                                "time_max": f"{r.time_max:.6g}",
                                "time_avg": f"{r.time_avg:.6g}",
                                "gflops": f"{r.gflops:.4g}",
                                "gnnzs": f"{mat.nnz / r.time_min / 1e9:.4g}",
                            }
                        row = {
                            "matrix": name, "kernel": kname_row,
                            "k": args.k,
                            "srs": srs, "rows": mat.m, "nnz": mat.nnz,
                            **times,
                            "num_wrong": wrong, "rel_l2": f"{rel:.3g}",
                            "pad_ratio": f"{pad:.3f}", "max_nb": nb,
                            "bin_blocks": bb,
                        }
                    except Exception:
                        traceback.print_exc()
                        continue
                    writer.writerow(row)
                    f.flush()
                    print(
                        f"{name} {kname} srs={srs}: "
                        f"{row['gflops'] or '(not timed)'} GFLOP/s "
                        f"wrong={wrong}"
                    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
