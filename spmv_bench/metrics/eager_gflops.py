"""2 nnz(A) x the calls completed, over the whole window, in GFLOP/s:
spmv_gflops's count, read per layer in cells where the host's issue
bounds the loop, since the host's speed drifts between runs by more
than an end-to-end bound can hold."""

from spmv_bench.metrics.spmv_gflops import read  # noqa: F401
