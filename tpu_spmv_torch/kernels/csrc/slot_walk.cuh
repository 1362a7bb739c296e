// One thread per row, walking that row's slots of a rank-windowed slab
// layout: the body shared by csrc/packed.cu (spmv_packed) and
// csrc/spmm.cu (spmm_ranked, spmm_packed). csrc/sts.cu (the ranked
// solve) reuses its column decode, SubTile and slot_base.
//
// Layout (tpu_spmv_torch/formats/{sell,packed}.py): 128 rows form a
// chunk, one row per lane; slot k of the slabs holds, at lane l, a
// value vals[k, l] and a window-local column lcols[k, l]. Slot k lies
// in sub-tile s = k >> 3 at sublane r = k & 7, and its column is
//   col = 128 * base(s, r) + lcols[k, l],
//   base(s, r) = sub_b0[s] + byte r of sub_dlo (r < 4) / sub_dhi (r >= 4)
// decoded as uint32 with logical shifts (a signed shift would
// sign-extend a byte >= 128), or, when G > 0,
//   base(s, r) = grp_b0[s * G + group(r)], group(r) = 4-bit field r of
// gmap. Chunk c owns slots [range[c] << shift, range[c+1] << shift):
// shift 0 for a packed layout's chunk_koff (slot offsets), 3 for a
// ranked layout's chunk_ptr (sub-tile offsets). Slots past a chunk's
// true row length hold val 0 and an in-range column; slots past the
// last chunk are never read.
//
// A thread owns row (chunk c = row / 128, lane row % 128) and a tile of
// up to TB columns of X (n, B) and Y (m, B), both row-major; grid.y
// walks the column tiles. It keeps TB sums in registers and writes its
// row of Y once, so nothing crosses threads or blocks: the TPU kernels'
// per-sub-tile partials, the packed kernels' carry across sub-tiles and
// grid steps, and the out_row gather or segment-sum after them do not
// exist here. The 32 threads of a warp share a chunk, so the walk is
// uniform within a warp and the metadata loads are broadcasts. A
// sub-tile wholly inside the chunk (every sub-tile of a ranked layout,
// and the bulk of a long packed row) runs its 8 slots unrolled, so their
// loads issue together; the slots of a sub-tile that the chunk shares
// with its neighbours run in a plain loop. (Of three variants timed on
// the H100, unrolling the shared sub-tiles too, predicated per slot, or
// with every load unconditional, made banded_1m's long row 1.8x to 3.8x
// slower.) A column outside [0, n) adds 0.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWalkLanes = 128;
constexpr int kWalkThreads = 256;

__device__ __forceinline__ float walk_widen(float v) { return v; }
__device__ __forceinline__ float walk_widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct SubTile {
  long long b0;
  unsigned lo, hi;
  long long s;
};

__device__ __forceinline__ long long slot_base(const SubTile& t, int r,
                                               const int* __restrict__ grp_b0,
                                               int G, unsigned gmap) {
  if (G > 0) {
    return grp_b0[t.s * G + ((gmap >> (4 * r)) & 15u)];
  }
  const unsigned word = r < 4 ? t.lo : t.hi;
  return t.b0 + ((word >> (8 * (r & 3))) & 255u);
}

template <typename V, typename L, int TB>
__device__ __forceinline__ void slot_fma(const V* __restrict__ vals,
                                         const L* __restrict__ lcols,
                                         long long base, long long k,
                                         int lane, const float* __restrict__ X,
                                         long long n, int B, int j0,
                                         float (&acc)[TB]) {
  const long long idx = k * kWalkLanes + lane;
  const long long col = base * kWalkLanes + (long long)lcols[idx];
  if ((unsigned long long)col < (unsigned long long)n) {
    const float v = walk_widen(vals[idx]);
    const float* xr = X + col * B + j0;
#pragma unroll
    for (int j = 0; j < TB; ++j) {
      if (j0 + j < B) acc[j] += v * xr[j];
    }
  }
}

template <typename V, typename L, int TB>
__global__ void __launch_bounds__(kWalkThreads)
    slot_walk_kernel(const V* __restrict__ vals, const L* __restrict__ lcols,
                     const int* __restrict__ sub_b0,
                     const unsigned* __restrict__ sub_dlo,
                     const unsigned* __restrict__ sub_dhi,
                     const int* __restrict__ grp_b0, int G, unsigned gmap,
                     const int* __restrict__ range, int shift,
                     const float* __restrict__ X, float* __restrict__ Y,
                     long long m, long long n, int B) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= m) return;
  const int j0 = blockIdx.y * TB;
  const long long c = row / kWalkLanes;
  const int lane = (int)(row % kWalkLanes);
  const long long k1 = (long long)range[c + 1] << shift;
  float acc[TB];
#pragma unroll
  for (int j = 0; j < TB; ++j) acc[j] = 0.f;

  for (long long k = (long long)range[c] << shift; k < k1;) {
    SubTile t;
    t.s = k >> 3;
    t.b0 = 0;
    t.lo = t.hi = 0;
    if (G == 0) {
      t.b0 = sub_b0[t.s];
      t.lo = sub_dlo[t.s];
      t.hi = sub_dhi[t.s];
    }
    const long long first = t.s << 3;
    const long long kend = (first + 8 < k1) ? first + 8 : k1;
    if (k == first && kend == first + 8) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        slot_fma<V, L, TB>(vals, lcols, slot_base(t, r, grp_b0, G, gmap),
                           first + r, lane, X, n, B, j0, acc);
      }
      k = kend;
    } else {
      for (; k < kend; ++k) {
        slot_fma<V, L, TB>(vals, lcols,
                           slot_base(t, (int)(k & 7), grp_b0, G, gmap), k,
                           lane, X, n, B, j0, acc);
      }
    }
  }
  float* yr = Y + row * B + j0;
#pragma unroll
  for (int j = 0; j < TB; ++j) {
    if (j0 + j < B) yr[j] = acc[j];
  }
}

template <typename V, typename L, int TB>
void launch_walk(const void* vals, const void* lcols, const void* sub_b0,
                 const void* sub_dlo, const void* sub_dhi, const void* grp_b0,
                 int G, unsigned gmap, const void* range, int shift,
                 const void* X, void* Y, long long m, long long n, int B,
                 cudaStream_t s) {
  const dim3 grid((unsigned)((m + kWalkThreads - 1) / kWalkThreads),
                  (unsigned)((B + TB - 1) / TB));
  slot_walk_kernel<V, L, TB><<<grid, kWalkThreads, 0, s>>>(
      static_cast<const V*>(vals), static_cast<const L*>(lcols),
      static_cast<const int*>(sub_b0), static_cast<const unsigned*>(sub_dlo),
      static_cast<const unsigned*>(sub_dhi), static_cast<const int*>(grp_b0),
      G, gmap, static_cast<const int*>(range), shift,
      static_cast<const float*>(X), static_cast<float*>(Y), m, n, B);
}

// val_kind: 0 float32, 1 bfloat16. lcol_kind: 0 uint8, 1 int16, 2 int32.
// Returns cudaErrorInvalidValue for an unknown kind, else the launch's
// cudaGetLastError().
template <int TB>
int dispatch_walk(int val_kind, int lcol_kind, const void* vals,
                  const void* lcols, const void* sub_b0, const void* sub_dlo,
                  const void* sub_dhi, const void* grp_b0, int G,
                  unsigned gmap, const void* range, int shift, const void* X,
                  void* Y, long long m, long long n, int B, void* stream) {
  if (B < 1 || (B + TB - 1) / TB > 65535 || G < 0 || G > 8 ||
      (shift != 0 && shift != 3)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TSP_WALK(V, L)                                                        \
  launch_walk<V, L, TB>(vals, lcols, sub_b0, sub_dlo, sub_dhi, grp_b0, G,     \
                        gmap, range, shift, X, Y, m, n, B, s)
  if (val_kind == 0 && lcol_kind == 0) {
    TSP_WALK(float, uint8_t);
  } else if (val_kind == 0 && lcol_kind == 1) {
    TSP_WALK(float, int16_t);
  } else if (val_kind == 0 && lcol_kind == 2) {
    TSP_WALK(float, int32_t);
  } else if (val_kind == 1 && lcol_kind == 0) {
    TSP_WALK(__nv_bfloat16, uint8_t);
  } else if (val_kind == 1 && lcol_kind == 1) {
    TSP_WALK(__nv_bfloat16, int16_t);
  } else if (val_kind == 1 && lcol_kind == 2) {
    TSP_WALK(__nv_bfloat16, int32_t);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef TSP_WALK
  return (int)cudaGetLastError();
}

}  // namespace
