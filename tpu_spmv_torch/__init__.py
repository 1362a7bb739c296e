"""tpu_spmv_torch — the PyTorch + CUDA port of tpu_spmv, for one NVIDIA
H100 (Hopper, sm_90a).

The JAX package `tpu_spmv` stays the reference: each part of the port is
tested against it on the same inputs. The port imports torch and never
jax. Host code that touches no device is reused from `tpu_spmv` as it is
(CSRMatrix and CSRkMatrix, io, RCM with its C++ core, the synthetic
matrices); everything that builds a device layout, runs a kernel or
times one is the port's own.

Layer map (single-vector SpMV, y = A @ x):

    tools/    CLI entry points: spmv (load, reorder, plan, build, run,
              validate, time) and info (card and toolchain)
    tune/     gpu_plan: DIA for constant-diagonal matrices, else ranked
    formats/  DiaSlabs, SellSlabs, RankedSlabs as torch containers, built
              on the host with NumPy; convert carries JAX layouts across
    kernels/  CUDA C++ kernels (csrc/*.cu, built with nvcc into one
              ctypes-bound library) with a plain PyTorch version beside
              each: spmv_dia, spmv_ranked, spmv_sell
    bench/    CUDA-event timing (warm and cold regimes) and validation
    hw        DeviceSpec of the card, nvidia-smi, the toolchain report
"""

__version__ = "0.1.0"
