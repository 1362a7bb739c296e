// SELL-slab SpMV for Hopper (sm_90a): the ranked and sell kernels.
//
// Replaces the Pallas kernels of tpu_spmv/kernels/pallas_sell.py:
//   spmv_ranked (_make_ranked_kernel, _make_grouped_kernel) and
//   spmv_sell (_make_kernel), together with their _reduce_partials
//   epilogue.
//
// Layout (tpu_spmv_torch/formats/sell.py): 128 rows form a chunk, one row
// per lane; a chunk's nonzeros are slot-major (k, 128) slabs, 8 slots
// to a sub-tile; chunk_ptr[c] .. chunk_ptr[c+1] are chunk c's sub-tiles.
//
// Design: one thread per row (chunk c = row / 128, lane l = row % 128).
// The thread walks its chunk's sub-tiles and their 8 slots, gathers x
// at each slot's column and writes y[row] once, so the per-sub-tile
// partials and the segment-sum of the TPU version do not exist. The
// TPU kernel looped over x blocks and selected lanes with a 128-lane
// gather from VMEM; a thread here computes its column and reads x
// directly (rows >= m and the all-pad tail are never touched).
//
// Ranked columns: col = 128 * base(s, r) + lcols[8s + r, l], with
//   base(s, r) = sub_b0[s] + byte r of sub_dlo (r < 4) / sub_dhi (r >= 4),
// decoded as uint32 with logical shifts (a signed shift would
// sign-extend any byte >= 128), or, for a grouped layout (G > 0),
//   base(s, r) = grp_b0[s * G + group(r)], group(r) = 4-bit field r of
// gmap. lcols is uint8, int16 or int32 and is widened as its own type.
// Sell columns are absolute int32.
//
// What bounds it: bytes. Ranked streams the padded slots once, value
// plus local column (4 or 2 B + 1, 2 or 4 B per slot), plus the
// per-sub-tile metadata (read once per warp, a broadcast) and the x
// gathers, which hit L2 when the matrix is banded. Slab loads are
// coalesced across a warp's 32 lanes. wgmma does not apply; TMA or
// cp.async staging of x windows in shared memory is work for later
// changes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 128;
constexpr int kSublanes = 8;
constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename V, typename L>
__global__ void ranked_kernel(const V* __restrict__ vals,
                              const L* __restrict__ lcols,
                              const int* __restrict__ sub_b0,
                              const unsigned* __restrict__ sub_dlo,
                              const unsigned* __restrict__ sub_dhi,
                              const int* __restrict__ grp_b0, int G,
                              unsigned gmap,
                              const int* __restrict__ chunk_ptr,
                              const float* __restrict__ x,
                              float* __restrict__ y, long long m,
                              long long n) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= m) return;
  const long long c = row / kLanes;
  const int lane = (int)(row % kLanes);
  const int s0 = chunk_ptr[c];
  const int s1 = chunk_ptr[c + 1];
  float acc = 0.f;
  for (int s = s0; s < s1; ++s) {
    long long base[kSublanes];
    if (G > 0) {
#pragma unroll
      for (int r = 0; r < kSublanes; ++r) {
        base[r] = grp_b0[(long long)s * G + ((gmap >> (4 * r)) & 15u)];
      }
    } else {
      const long long b0 = sub_b0[s];
      const unsigned lo = sub_dlo[s];
      const unsigned hi = sub_dhi[s];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        base[r] = b0 + ((lo >> (8 * r)) & 255u);
        base[r + 4] = b0 + ((hi >> (8 * r)) & 255u);
      }
    }
    const long long k0 = (long long)s * kSublanes * kLanes + lane;
    float part = 0.f;
#pragma unroll
    for (int r = 0; r < kSublanes; ++r) {
      const long long idx = k0 + r * kLanes;
      const long long col = base[r] * kLanes + (long long)lcols[idx];
      const float xv = (col < n) ? x[col] : 0.f;
      part += widen(vals[idx]) * xv;
    }
    acc += part;
  }
  y[row] = acc;
}

__global__ void sell_kernel(const float* __restrict__ vals,
                            const int* __restrict__ cols,
                            const int* __restrict__ chunk_ptr,
                            const float* __restrict__ x,
                            float* __restrict__ y, long long m, long long n) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= m) return;
  const long long c = row / kLanes;
  const int lane = (int)(row % kLanes);
  const int s0 = chunk_ptr[c];
  const int s1 = chunk_ptr[c + 1];
  float acc = 0.f;
  for (int s = s0; s < s1; ++s) {
    const long long k0 = (long long)s * kSublanes * kLanes + lane;
    float part = 0.f;
#pragma unroll
    for (int r = 0; r < kSublanes; ++r) {
      const long long idx = k0 + r * kLanes;
      const int col = cols[idx];
      const float xv = (col >= 0 && col < n) ? x[col] : 0.f;
      part += vals[idx] * xv;
    }
    acc += part;
  }
  y[row] = acc;
}

template <typename V, typename L>
void launch_ranked(const void* vals, const void* lcols, const void* sub_b0,
                   const void* sub_dlo, const void* sub_dhi,
                   const void* grp_b0, int G, unsigned gmap,
                   const void* chunk_ptr, const void* x, void* y,
                   long long m, long long n, cudaStream_t s) {
  const unsigned blocks = (unsigned)((m + kThreads - 1) / kThreads);
  ranked_kernel<V, L><<<blocks, kThreads, 0, s>>>(
      static_cast<const V*>(vals), static_cast<const L*>(lcols),
      static_cast<const int*>(sub_b0), static_cast<const unsigned*>(sub_dlo),
      static_cast<const unsigned*>(sub_dhi), static_cast<const int*>(grp_b0),
      G, gmap, static_cast<const int*>(chunk_ptr),
      static_cast<const float*>(x), static_cast<float*>(y), m, n);
}

template <typename V>
int dispatch_lcols(int lcol_kind, const void* vals, const void* lcols,
                   const void* sub_b0, const void* sub_dlo,
                   const void* sub_dhi, const void* grp_b0, int G,
                   unsigned gmap, const void* chunk_ptr, const void* x,
                   void* y, long long m, long long n, cudaStream_t s) {
  switch (lcol_kind) {
    case 0:
      launch_ranked<V, uint8_t>(vals, lcols, sub_b0, sub_dlo, sub_dhi, grp_b0,
                                G, gmap, chunk_ptr, x, y, m, n, s);
      return 0;
    case 1:
      launch_ranked<V, int16_t>(vals, lcols, sub_b0, sub_dlo, sub_dhi, grp_b0,
                                G, gmap, chunk_ptr, x, y, m, n, s);
      return 0;
    case 2:
      launch_ranked<V, int32_t>(vals, lcols, sub_b0, sub_dlo, sub_dhi, grp_b0,
                                G, gmap, chunk_ptr, x, y, m, n, s);
      return 0;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// val_kind: 0 float32, 1 bfloat16. lcol_kind: 0 uint8, 1 int16, 2 int32.
// G = 0 selects the packed-delta bases; G > 0 the grouped ones.
extern "C" int tsp_spmv_ranked(int val_kind, int lcol_kind, const void* vals,
                               const void* lcols, const void* sub_b0,
                               const void* sub_dlo, const void* sub_dhi,
                               const void* grp_b0, int G, unsigned gmap,
                               const void* chunk_ptr, const void* x, void* y,
                               long long m, long long n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (val_kind == 0) {
    rc = dispatch_lcols<float>(lcol_kind, vals, lcols, sub_b0, sub_dlo,
                               sub_dhi, grp_b0, G, gmap, chunk_ptr, x, y, m,
                               n, s);
  } else if (val_kind == 1) {
    rc = dispatch_lcols<__nv_bfloat16>(lcol_kind, vals, lcols, sub_b0,
                                       sub_dlo, sub_dhi, grp_b0, G, gmap,
                                       chunk_ptr, x, y, m, n, s);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

extern "C" int tsp_spmv_sell(const void* vals, const void* cols,
                             const void* chunk_ptr, const void* x, void* y,
                             long long m, long long n, void* stream) {
  const unsigned blocks = (unsigned)((m + kThreads - 1) / kThreads);
  sell_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(cols),
      static_cast<const int*>(chunk_ptr), static_cast<const float*>(x),
      static_cast<float*>(y), m, n);
  return (int)cudaGetLastError();
}
