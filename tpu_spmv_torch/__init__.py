"""tpu_spmv_torch — the PyTorch + CUDA port of tpu_spmv, for one NVIDIA
H100 (Hopper, sm_90a).

The JAX package `tpu_spmv` stays the reference: each part of the port is
tested against it on the same inputs. The port imports torch, never jax
and nothing of `tpu_spmv`: it carries its own copies of the host code
that touches no device (CSRMatrix and CSRkMatrix, io, RCM with its C++
core, the synthetic matrices), held equal to the originals by tests.

Layer map (SpMV, y = A @ x; SpMM, Y = A @ X; the triangular solve
L x = b and IC(0)-PCG):

    tools/    CLI entry points: spmv and spmm (load, reorder, plan, build,
              run, validate, time), sts (triangular solve), solve
              (IC(0)-PCG on one card) and info (card and toolchain)
    sts/      pack schedule (host), LowerSolveLayout and lower_solve,
              IC(0) factor, preconditioner and PCG
    tune/     gpu_plan: DIA for constant-diagonal matrices, else packed or
              ranked by sub-tile count and the measured time ratio of the
              kernels that will run (one for SpMV, one for SpMM)
    formats/  CSRMatrix, CSRkMatrix; DiaSlabs, SellSlabs, RankedSlabs,
              PackedRanked as torch containers, built on the host with
              NumPy; convert carries JAX layouts across
    reorder/  RCM, coarsening, permutation composition, and the C++ host
              core (reorder/csrc/reorder.cc, built with g++ on first use)
    io/       MatrixMarket and .csr/.csr2/.csr3 text formats
    kernels/  CUDA C++ kernels (csrc/*.cu, built with nvcc into one
              ctypes-bound library) with a plain PyTorch version beside
              each: spmv_dia, spmv_ranked, spmv_sell, spmv_packed,
              spmm_ranked, spmm_packed, lower_solve_ranked,
              lower_solve_blocks, and the windowed spmv_dia_windowed,
              spmv_ranked_windowed and spmm_ranked_windowed; the x
              residency gates that choose between resident and windowed
    bench/    CUDA-event timing (warm and cold regimes), validation and
              the synthetic matrices
    hw        DeviceSpec of the card, nvidia-smi, the toolchain report
"""

__version__ = "0.1.0"
