"""tpu_spmv_torch — the PyTorch + CUDA port of tpu_spmv, for one NVIDIA
H100 (Hopper, sm_90a).

The JAX package `tpu_spmv` stays the reference: each part of the port is
tested against it on the same inputs. The port imports torch and never
jax. Host code that touches no device is reused from `tpu_spmv` as it is
(CSRMatrix and CSRkMatrix, io, RCM with its C++ core, the synthetic
matrices); everything that builds a device layout, runs a kernel or
times one is the port's own.

Layer map (SpMV, y = A @ x; SpMM, Y = A @ X; the triangular solve
L x = b and IC(0)-PCG):

    tools/    CLI entry points: spmv and spmm (load, reorder, plan, build,
              run, validate, time), sts (triangular solve), solve
              (IC(0)-PCG on one card) and info (card and toolchain)
    sts/      pack schedule (host), LowerSolveLayout and lower_solve,
              IC(0) factor, preconditioner and PCG
    tune/     gpu_plan: DIA for constant-diagonal matrices, else packed or
              ranked by sub-tile count and a measured time ratio
    formats/  DiaSlabs, SellSlabs, RankedSlabs, PackedRanked as torch
              containers, built on the host with NumPy; convert carries
              JAX layouts across
    kernels/  CUDA C++ kernels (csrc/*.cu, built with nvcc into one
              ctypes-bound library) with a plain PyTorch version beside
              each: spmv_dia, spmv_ranked, spmv_sell, spmv_packed,
              spmm_ranked, spmm_packed, lower_solve_ranked and
              lower_solve_blocks
    bench/    CUDA-event timing (warm and cold regimes) and validation
    hw        DeviceSpec of the card, nvidia-smi, the toolchain report
"""

__version__ = "0.1.0"
