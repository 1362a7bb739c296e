// Deterministic sums over the CTAs of a launch (or of two launches on
// one stream): the dot products of the fused CG iteration (csrc/cg.cu,
// and the p.Ap epilogue of csrc/sell.cu's segment walk).
//
// Each CTA sums its threads' terms in a fixed order (a shuffle tree in
// each warp, then the warps in order), writes that sum into its own slot
// of a partials buffer, fences, and counts itself done on a counter. The
// CTA that brings the counter to `total` adds every partial in slot
// order into *out and zeroes the counter for the next launch. No float
// atomics: two launches from the same inputs give the same bits,
// whichever CTA finishes last, and a CUDA graph replays the launch with
// no host work between.

#pragma once

#include <cuda_runtime.h>

namespace {

// The sum of v over the block's kThreads threads (a multiple of 32), on
// thread 0: each warp by a shuffle tree, then the warps in order. Every
// thread of the block must call it (it holds a barrier).
template <int kThreads>
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warps[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0) warps[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
    s = warps[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) s += warps[w];
  }
  return s;
}

// Slot `slot` of `total` partials: thread 0 passes its CTA's sum (from
// block_sum). The last CTA to count itself adds partials[0..total) in
// slot order into *out (thread t takes slots t, t + kThreads, ... in
// order, eight loads in flight, then block_sum) and zeroes *count.
// Every thread of the block must call it.
template <int kThreads>
__device__ __forceinline__ void grid_sum(float cta_sum, int slot, int total,
                                         float* partials, unsigned* count,
                                         float* out) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partials[slot] = cta_sum;
    __threadfence();
    last = atomicAdd(count, 1u) == (unsigned)total - 1u;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float acc = 0.f;
  int i = threadIdx.x;
  for (; i + 7 * kThreads < total; i += 8 * kThreads) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __ldcg(partials + i + j * kThreads);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc += v[j];
  }
  for (; i < total; i += kThreads) acc += __ldcg(partials + i);
  const float s = block_sum<kThreads>(acc);
  if (threadIdx.x == 0) {
    *out = s;
    *count = 0u;
  }
}

}  // namespace
