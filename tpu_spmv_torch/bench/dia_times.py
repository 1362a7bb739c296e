"""Warm times of spmv_dia_windowed beside the resident spmv_dia on their
main matrices, for comparing two trees of the port on one card.

    python -m tpu_spmv_torch.bench.dia_times [--tag NAME]
        [--cases lap2d_4096:f32 lap2d_4096:bf16 lap2d_1024:f32]
        [--step-rows S [S ...]]

On each case (lap2d_4096: 16.8M rows, x 67 MB, past half the L2;
lap2d_1024: 1M rows; natural order, DIA layout in the case's value type)
it times (warm TimeMin, CUDA graph, bench/harness.bench_spmv, twice
each) spmv_dia_windowed and spmv_dia on the same layout and x, one line
each, with the windowed kernel's largest difference from spmv_dia, after
the card's nvidia-smi name and power limit and the rate of a 400 MB
device-to-device copy (torch's copy_, best of 20: the rate a stream that
reads and writes device memory reaches on this card, beside the data
sheet's 3.35 TB/s that the bounds use). It uses only what every tree of
the port has, so another tree's package can be timed by running this
file with that tree first on PYTHONPATH.

--step-rows also times spmv_dia_windowed with its step cut at each S in
turn (kernels/dia.DIA_STEP_ROWS), where the tree has the ring.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

CASES = ("lap2d_4096:f32", "lap2d_4096:bf16", "lap2d_1024:f32")


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--cases", nargs="*", default=CASES, choices=CASES)
    ap.add_argument("--step-rows", type=int, nargs="*", default=())
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the times are the card's")

    from tpu_spmv_torch import hw
    from tpu_spmv_torch.formats.dia import DiaSlabs
    from tpu_spmv_torch.kernels import dia as kdia
    from tpu_spmv_torch.tools.spmv import load_input

    print(hw.nvidia_smi(), flush=True)
    dev = torch.device("cuda")
    print(f"{args.tag} {_copy_rate(dev)}", flush=True)
    loaded, mat = None, None
    for case in args.cases:
        name, tag = case.split(":")
        if name != loaded:
            loaded, mat = name, load_input(f"synthetic:{name}")
        vdt = torch.bfloat16 if tag == "bf16" else None
        lay = DiaSlabs.from_csr(mat, val_dtype=vdt).to(dev)
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(
            mat.n).astype(np.float32)).to(dev)
        diff = float((kdia.spmv_dia_windowed(lay, x)
                      - kdia.spmv_dia(lay, x)).abs().max())
        print(f"{args.tag} {case} spmv_dia_windowed: warm TimeMin us "
              f"{_time(kdia.spmv_dia_windowed, lay, x, mat.nnz)} "
              f"(max|windowed-dia| {diff:.3g})", flush=True)
        print(f"{args.tag} {case} spmv_dia on the same layout: warm TimeMin "
              f"us {_time(kdia.spmv_dia, lay, x, mat.nnz)}", flush=True)
        if not hasattr(kdia, "DIA_STEP_ROWS"):
            continue
        default = kdia.DIA_STEP_ROWS
        try:
            for rows in args.step_rows:
                kdia.DIA_STEP_ROWS = rows
                ring = kdia.dia_ring(lay, kdia.dia_smem_budget(dev))
                t = _time(kdia.spmv_dia_windowed, lay, x, mat.nnz)
                print(f"{args.tag} {case} spmv_dia_windowed S={ring.step_rows}"
                      f" (W={ring.ring}, {ring.smem} bytes, "
                      f"{kdia.dia_windowed_ctas(lay, ring)} CTAs): warm "
                      f"TimeMin us {t}", flush=True)
        finally:
            kdia.DIA_STEP_ROWS = default
        del lay
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
