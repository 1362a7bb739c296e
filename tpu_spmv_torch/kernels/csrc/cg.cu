// The vector half of the fused CG iteration (dist/solvers.cg_step on the
// card), after K1, the ranked walk with its p.Ap epilogue (csrc/sell.cu,
// tsp_spmv_ranked_dot):
//
//   K2 (tsp_cg_update)     alpha = rz / max(pAp, 1e-30);
//                          x += alpha p, r -= alpha Ap, in place;
//                          the shard's r.r into *rr.
//   K3 (tsp_cg_direction)  beta = rr / max(rz, 1e-30);
//                          p = r + beta p, in place; rz <- rr.
//
// Replaces no TPU kernel: the reference (tpu_spmv/dist/solvers.py
// cg_step) leaves these vector operations to XLA. They were torch's
// addcmul, clamp_min, divisions and cuBLAS dots, 16 graph nodes of an
// iteration, and the graph copied x, r, p and rz back into the state.
//
// pAp and rr arrive as the D shards' partials, added in shard order as
// dist/solvers._dot adds them (the same fold on every process of a
// group, after the all-gather). Each kernel's own r.r is a deterministic
// sum over its CTAs (grid_sum.cuh). The guards keep a NaN, as
// torch.clamp_min does. K3 reads rz in every CTA, so only the last CTA
// of the last shard's K3 writes it, after every CTA has read it (a
// counter); the other shards' K3 pass no counter and leave rz.
//
// What bounds them: bytes. K2 reads x, r, p, Ap and writes x, r (6
// passes of the shard); K3 reads r, p and writes p (3). Grid-stride
// loops of float4 where every vector is 16-byte aligned (4 floats a
// thread a pass), else of floats; about eight CTAs of 256 threads an SM.

#include <cuda_runtime.h>

#include "grid_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCtasPerSm = 8;

// max(v, 1e-30) that keeps a NaN.
__device__ __forceinline__ float guard(float v) {
  return v < 1e-30f ? 1e-30f : v;
}

// parts[0] + parts[1] + ... + parts[D-1], left to right.
__device__ __forceinline__ float shard_sum(const float* parts, int D) {
  float s = parts[0];
  for (int d = 1; d < D; ++d) s += parts[d];
  return s;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    cg_update_kernel(const float* __restrict__ pap, int D,
                     const float* __restrict__ rz, const float* __restrict__ p,
                     const float* __restrict__ ap, float* __restrict__ x,
                     float* __restrict__ r, long long n,
                     float* __restrict__ partials, unsigned* __restrict__ count,
                     float* __restrict__ rr_out) {
  // alpha = rz / max(pAp, 1e-30).
  __shared__ float alpha_s;
  if (threadIdx.x == 0) alpha_s = *rz / guard(shard_sum(pap, D));
  __syncthreads();
  const float alpha = alpha_s;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long lo = 0;  // the floats from here on go one at a time
  float rr = 0.f;
  if constexpr (kVec) {
    const long long n4 = n / 4;
    const float4* p4 = reinterpret_cast<const float4*>(p);
    const float4* a4 = reinterpret_cast<const float4*>(ap);
    float4* x4 = reinterpret_cast<float4*>(x);
    float4* r4 = reinterpret_cast<float4*>(r);
    for (long long k = first; k < n4; k += stride) {
      const float4 pv = p4[k];
      const float4 av = __ldcs(a4 + k);
      float4 xv = __ldcs(x4 + k);
      float4 rv = r4[k];
      xv.x = __fmaf_rn(alpha, pv.x, xv.x);
      xv.y = __fmaf_rn(alpha, pv.y, xv.y);
      xv.z = __fmaf_rn(alpha, pv.z, xv.z);
      xv.w = __fmaf_rn(alpha, pv.w, xv.w);
      rv.x = __fmaf_rn(-alpha, av.x, rv.x);
      rv.y = __fmaf_rn(-alpha, av.y, rv.y);
      rv.z = __fmaf_rn(-alpha, av.z, rv.z);
      rv.w = __fmaf_rn(-alpha, av.w, rv.w);
      __stcs(x4 + k, xv);
      r4[k] = rv;
      rr = __fmaf_rn(rv.x, rv.x, rr);
      rr = __fmaf_rn(rv.y, rv.y, rr);
      rr = __fmaf_rn(rv.z, rv.z, rr);
      rr = __fmaf_rn(rv.w, rv.w, rr);
    }
    lo = 4 * n4;
  }
  for (long long i = lo + first; i < n; i += stride) {
    x[i] = __fmaf_rn(alpha, p[i], x[i]);
    const float rv = __fmaf_rn(-alpha, ap[i], r[i]);
    r[i] = rv;
    rr = __fmaf_rn(rv, rv, rr);
  }
  grid_sum<kThreads>(block_sum<kThreads>(rr), blockIdx.x, gridDim.x,
                     partials, count, rr_out);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    cg_direction_kernel(const float* __restrict__ rr, int D,
                        float* __restrict__ rz, const float* __restrict__ r,
                        float* __restrict__ p, long long n,
                        unsigned* __restrict__ count) {
  // beta = rr / max(rz, 1e-30), and rr kept for the last CTA.
  __shared__ float beta_s, rr_s;
  if (threadIdx.x == 0) {
    rr_s = shard_sum(rr, D);
    beta_s = rr_s / guard(*rz);
  }
  __syncthreads();
  const float beta = beta_s;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long lo = 0;
  if constexpr (kVec) {
    const long long n4 = n / 4;
    const float4* r4 = reinterpret_cast<const float4*>(r);
    float4* p4 = reinterpret_cast<float4*>(p);
    for (long long k = first; k < n4; k += stride) {
      const float4 rv = r4[k];
      float4 pv = p4[k];
      pv.x = __fmaf_rn(beta, pv.x, rv.x);
      pv.y = __fmaf_rn(beta, pv.y, rv.y);
      pv.z = __fmaf_rn(beta, pv.z, rv.z);
      pv.w = __fmaf_rn(beta, pv.w, rv.w);
      p4[k] = pv;
    }
    lo = 4 * n4;
  }
  for (long long i = lo + first; i < n; i += stride) {
    p[i] = __fmaf_rn(beta, p[i], r[i]);
  }
  if (count == nullptr) return;
  // Every CTA has read rz (thread 0, above) before it counts itself.
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(count, 1u) == gridDim.x - 1u) {
      *rz = rr_s;
      *count = 0u;
    }
  }
}

bool aligned16(const void* a) {
  return reinterpret_cast<unsigned long long>(a) % 16 == 0;
}

// CTAs of a grid-stride pass over n floats (float4 where vec): one unit
// a thread, at most kCtasPerSm an SM and `cap`.
int pass_ctas(long long n, bool vec, int cap) {
  static int sms[64];
  int dev = 0;
  cudaGetDevice(&dev);
  int& count = sms[dev & 63];
  if (count == 0) {
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long units = vec ? (n + 3) / 4 : n;
  long long ctas = (units + kThreads - 1) / kThreads;
  if (ctas > (long long)count * kCtasPerSm) ctas = (long long)count * kCtasPerSm;
  if (ctas > cap) ctas = cap;
  return ctas < 1 ? 1 : (int)ctas;
}

}  // namespace

// K2. pap: the D shards' p.Ap; rz: the iteration's r.z; p, ap, x, r: the
// shard's n floats. partials: `cap` floats, one a CTA; count: 0 before
// the call and after it; rr_out: the shard's r.r after the update.
extern "C" int tsp_cg_update(const void* pap, int D, const void* rz,
                             const void* p, const void* ap, void* x, void* r,
                             long long n, void* partials, int cap, void* count,
                             void* rr_out, void* stream) {
  const bool vec = aligned16(p) && aligned16(ap) && aligned16(x) &&
                   aligned16(r);
  const int ctas = pass_ctas(n, vec, cap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TSP_UPDATE(V)                                                        \
  cg_update_kernel<V><<<ctas, kThreads, 0, s>>>(                             \
      static_cast<const float*>(pap), D, static_cast<const float*>(rz),      \
      static_cast<const float*>(p), static_cast<const float*>(ap),           \
      static_cast<float*>(x), static_cast<float*>(r), n,                     \
      static_cast<float*>(partials), static_cast<unsigned*>(count),          \
      static_cast<float*>(rr_out))
  if (vec) {
    TSP_UPDATE(true);
  } else {
    TSP_UPDATE(false);
  }
#undef TSP_UPDATE
  return (int)cudaGetLastError();
}

// K3. rr: the D shards' r.r; rz: the iteration's, replaced by their sum
// when count is given (0 before the call and after it); r, p: the
// shard's n floats.
extern "C" int tsp_cg_direction(const void* rr, int D, void* rz,
                                const void* r, void* p, long long n,
                                void* count, void* stream) {
  const bool vec = aligned16(r) && aligned16(p);
  const int ctas = pass_ctas(n, vec, 1 << 30);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TSP_DIRECTION(V)                                                \
  cg_direction_kernel<V><<<ctas, kThreads, 0, s>>>(                     \
      static_cast<const float*>(rr), D, static_cast<float*>(rz),        \
      static_cast<const float*>(r), static_cast<float*>(p), n,          \
      static_cast<unsigned*>(count))
  if (vec) {
    TSP_DIRECTION(true);
  } else {
    TSP_DIRECTION(false);
  }
#undef TSP_DIRECTION
  return (int)cudaGetLastError();
}
