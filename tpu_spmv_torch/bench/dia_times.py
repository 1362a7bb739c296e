"""Warm times of spmv_dia_windowed beside the resident spmv_dia on their
main matrices, for comparing two trees of the port on one card.

    python -m tpu_spmv_torch.bench.dia_times [--tag NAME]
        [--cases lap2d_4096:f32 lap2d_4096:bf16 lap2d_1024:f32
                 hpcg27_256:f32 hpcg27_512x512x64:f32 lap3d_256:f32]
        [--step-rows S [S ...]]

The cases, natural order, DIA layout in the case's value type, and the
route kernels/dia.dia_route picks for each on an H100:

- lap2d_4096: 16.8M rows, x 67 MB, past half the L2; windowed, one ring.
- lap2d_1024: 1M rows; resident, x fits.
- hpcg27_256 (not run by default, nor the two below): HPCG's 27-point
  operator on NVIDIA's 256^3 grid, 16.8M rows and 449M nonzeros; no ring
  fits; resident, its reuse window (15.3 MB) within the budget.
- hpcg27_512x512x64: the same operator on 512 x 512 x 64, 16.8M rows; no
  ring fits; resident, its reuse window (60.9 MB) past the budget.
- lap3d_256: the 7-point Laplacian on 256^3, 16.8M rows; no ring fits;
  resident, its reuse window (4.7 MB) within the budget.

On each case it prints the route where the tree has dia_route, and
times (warm TimeMin, CUDA graph, bench/harness.bench_spmv, twice each)
spmv_dia and then spmv_dia_windowed on the same layout and x, one line
each, the windowed kernel's with its largest difference from spmv_dia
and whether the two are bit-equal ("no ring fits" where its ring does
not fit shared memory), after
the card's nvidia-smi name and power limit and the rate of a 400 MB
device-to-device copy (torch's copy_, best of 20: the rate a stream that
reads and writes device memory reaches on this card, beside the data
sheet's 3.35 TB/s that the bounds use). It uses only what every tree of
the port has, so another tree's package can be timed by running this
file with that tree first on PYTHONPATH.

--step-rows also times spmv_dia_windowed with its step cut at each S in
turn (kernels/dia.DIA_STEP_ROWS), where the ring fits.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

CASES = ("lap2d_4096:f32", "lap2d_4096:bf16", "lap2d_1024:f32")
CHOICES = CASES + ("hpcg27_256:f32", "hpcg27_512x512x64:f32",
                   "lap3d_256:f32")


def _matrix(name: str):
    from tpu_spmv_torch.bench.matrices import laplacian_3d
    from tpu_spmv_torch.bench.solve_times import hpcg27
    from tpu_spmv_torch.tools.spmv import load_input

    if name == "hpcg27_256":
        return hpcg27(256)
    if name == "hpcg27_512x512x64":
        return hpcg27(512, 64)
    if name == "lap3d_256":
        return laplacian_3d(256)
    return load_input(f"synthetic:{name}")


def _time(fn, lay, x, nnz: int) -> str:
    from tpu_spmv_torch.bench.harness import bench_spmv

    return " ".join(f"{bench_spmv(fn, lay, x, nnz=nnz).time_min * 1e6:.2f}"
                    for _ in range(2))


def _copy_rate(dev, floats: int = 100_000_000) -> str:
    src = torch.ones(floats, device=dev)
    dst = torch.empty_like(src)
    dst.copy_(src)
    best = float("inf")
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        dst.copy_(src)
        stop.record()
        stop.synchronize()
        best = min(best, start.elapsed_time(stop) / 1e3)
    moved = 2 * 4 * floats
    return (f"device copy of {4 * floats / 1e6:.0f} MB: {best * 1e6:.1f} us, "
            f"{moved / best / 1e12:.3f} TB/s read + write")


def _windowed(tag: str, kdia, lay, x, nnz: int, step_rows) -> None:
    """One line a step, at the step dia_ring picks and then at each S of
    `step_rows`: spmv_dia_windowed's ring, warm time, largest difference
    from spmv_dia and whether the two are bit-equal; "no ring fits"
    where the ring does not fit."""
    y_dia = kdia.spmv_dia(lay, x)
    default = kdia.DIA_STEP_ROWS
    try:
        for rows in (default, *step_rows):
            kdia.DIA_STEP_ROWS = rows
            try:
                ring = kdia.dia_ring(lay, kdia.dia_smem_budget(x.device))
            except ValueError:
                print(f"{tag} spmv_dia_windowed S<={rows}: no ring fits",
                      flush=True)
                continue
            y_win = kdia.spmv_dia_windowed(lay, x)
            print(f"{tag} spmv_dia_windowed S={ring.step_rows} "
                  f"(W={ring.ring}, {ring.smem} bytes, "
                  f"{kdia.dia_windowed_ctas(lay, ring)} CTAs): warm TimeMin "
                  f"us {_time(kdia.spmv_dia_windowed, lay, x, nnz)} "
                  f"(max|windowed-dia| {(y_win - y_dia).abs().max():.3g}, "
                  f"bit-equal {torch.equal(y_win, y_dia)})", flush=True)
    finally:
        kdia.DIA_STEP_ROWS = default


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--cases", nargs="*", default=CASES, choices=CHOICES)
    ap.add_argument("--step-rows", type=int, nargs="*", default=())
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the times are the card's")

    from tpu_spmv_torch import hw
    from tpu_spmv_torch.formats.dia import DiaSlabs
    from tpu_spmv_torch.kernels import dia as kdia

    print(hw.nvidia_smi(), flush=True)
    dev = torch.device("cuda")
    print(f"{args.tag} {_copy_rate(dev)}", flush=True)
    loaded, mat = None, None
    for case in args.cases:
        name, tag = case.split(":")
        if name != loaded:
            loaded, mat = name, None
            mat = _matrix(name)
        vdt = torch.bfloat16 if tag == "bf16" else None
        lay = DiaSlabs.from_csr(mat, val_dtype=vdt).to(dev)
        if hasattr(kdia, "dia_route"):
            route = kdia.dia_route(lay)
            print(f"{args.tag} {case} route: {route.kernel} ({route.rule}; "
                  f"x {route.x_bytes} B, reuse window {route.window_bytes} B,"
                  f" budget {route.budget_bytes} B)", flush=True)
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(
            mat.n).astype(np.float32)).to(dev)
        print(f"{args.tag} {case} spmv_dia: warm TimeMin us "
              f"{_time(kdia.spmv_dia, lay, x, mat.nnz)}", flush=True)
        _windowed(f"{args.tag} {case}", kdia, lay, x, mat.nnz,
                  args.step_rows)
        del lay
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
