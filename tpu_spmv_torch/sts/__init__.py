"""Sparse triangular solve and IC(0)-PCG (counterpart of `tpu_spmv.sts`).

    host    pack schedule and permuted triangular system (NumPy only)
    solve   LowerSolveLayout and the chunk-ordered lower solve
    ic0     IC(0) factor, its two-solve preconditioner and PCG

Unlike `tpu_spmv/sts/__init__.py`, this init imports nothing, so
`tpu_spmv_torch.sts.host` loads neither torch's solve module nor JAX.
"""
