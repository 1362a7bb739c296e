// DIA SpMV for Hopper (sm_90a).
//
// Replaces the Pallas kernel tpu_spmv/kernels/dia.py:spmv_dia
// (_make_dia_kernel): y[row] = sum_k vals[t, k, r, l] * x[row + off_k],
// with row = (t*rb + r)*128 + l and x read as 0 outside [0, n).
//
// Design: one thread per row. The TPU kernel split each offset into a
// block shift plus a lane rotation of a VMEM-resident x; here each
// thread indexes x directly, and neighbouring threads read neighbouring
// addresses of x and of each diagonal's values, so every load is
// coalesced. A bounds predicate takes the place of the zero guard
// blocks. bf16 values are widened with __bfloat162float and the sum is
// kept in f32, adding the diagonals in ascending offset order.
//
// What bounds it: bytes. It streams D * rows * (4 or 2) B of values
// once, reads x about once (the D shifted reads of a warp overlap in
// L1/L2) and writes y once; there is almost no arithmetic per byte.
// Staging x in shared memory, TMA loads and wider vector loads are work
// for later changes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename V>
__global__ void dia_kernel(const V* __restrict__ vals,
                           const int* __restrict__ offs, int D, int rb,
                           const float* __restrict__ x, float* __restrict__ y,
                           long long m, long long n) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= m) return;
  const long long blk = row >> 7;
  const long long t = blk / rb;
  const long long r = blk - t * rb;
  const long long stride = (long long)rb * 128;  // one diagonal of a tile
  const V* v = vals + t * D * stride + r * 128 + (row & 127);
  float acc = 0.f;
  for (int k = 0; k < D; ++k) {
    const long long col = row + offs[k];
    const float xv = (col >= 0 && col < n) ? x[col] : 0.f;
    acc += widen(v[k * stride]) * xv;
  }
  y[row] = acc;
}

}  // namespace

extern "C" int tsp_spmv_dia(int val_kind, const void* vals, const void* offs,
                            int D, int rb, const void* x, void* y,
                            long long m, long long n, void* stream) {
  constexpr int kThreads = 256;
  const unsigned blocks = (unsigned)((m + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* o = static_cast<const int*>(offs);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  if (val_kind == 0) {
    dia_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(vals), o, D, rb, xf, yf, m, n);
  } else if (val_kind == 1) {
    dia_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(vals), o, D, rb, xf, yf, m, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* tsp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
