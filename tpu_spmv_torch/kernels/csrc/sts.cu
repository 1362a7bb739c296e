// Chunk-ordered sparse lower-triangular solve for Hopper (sm_90a): the
// blocks and ranked solve kernels.
//
// Replaces the Pallas kernels of tpu_spmv/sts/solve.py:
//   lower_solve_blocks (_make_solve_kernel): absolute int32 columns;
//   _lower_solve_ranked (_make_ranked_solve_kernel): rank-windowed
//   columns, decoded from sub_b0 and the packed deltas only, as the TPU
//   kernel does (a grouped layout's deltas encode its group bases too).
//
// What both compute (tpu_spmv_torch/sts/solve.py builds the layout):
// strict-L, scaled by 1/diag, stored as SELL slabs over rows that are
// padded pack by pack to 128-row chunks, and
//   x[c] = b_scale[c] - sum over chunk c's slots of val * x[col],
// chunk by chunk in dependency order. A real slot of chunk c reads a row
// of an earlier pack, so a block < c: the rows of one pack are mutually
// independent (tpu_spmv_torch/sts/host.py).
//
// The TPU kernel gets that order from its grid, which runs in sequence
// on one core. CUDA blocks run in no order, so the order is built here:
//   - one CTA of 128 threads solves one chunk, a thread per row (lane).
//     The thread walks its chunk's sub-tiles through chunk_ptr and keeps
//     its sum in a register, so the TPU's (1, 128) accumulator and its
//     bit-30 "finalize" flag do not exist;
//   - chunks are handed out through a global ticket (atomicAdd by thread
//     0), not by blockIdx: CUDA does not start blocks in blockIdx order.
//     With tickets, every chunk a CTA waits on was handed to a CTA that
//     is already running, so the waits cannot deadlock;
//   - before it reads x[col], a thread waits until ready[col >> 7] is
//     set (an acquire load), then reads x through L2 (__ldcg: L1 is not
//     coherent across SMs). A slot whose block is >= c is padding (val
//     0; chunk 0's padding slots point at chunk 0 itself) and is skipped,
//     never waited on;
//   - a chunk's threads write their rows, fence, meet at __syncthreads,
//     and thread 0 releases ready[c].
// Each call zeroes x, the flags and the ticket with cudaMemsetAsync on
// its own stream, so a CUDA graph that captures a call replays all of
// it (replay freezes the arguments; nothing else needs resetting).
//
// What bounds it: latency along the chain of dependencies, not bytes. A
// chunk waits only on the chunks its rows read, so the time follows the
// system's dependency depth (1024 levels for the 2047 packs of lap2d_1024
// in level order), about 7-15 us per level on an H100. Fewer waits (a
// warp per chunk, one wait per distinct block) are later work.

#include <cuda_runtime.h>

#include <cstdint>

#include "slot_walk.cuh"

namespace {

constexpr int kSolveLanes = 128;
constexpr int kSolveSublanes = 8;

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// Absolute int32 columns (lower_solve_blocks).
struct AbsoluteCols {
  const int* __restrict__ cols;
  __device__ SubTile subtile(long long s) const {
    SubTile t{};
    t.s = s;
    return t;
  }
  __device__ long long col(const SubTile&, int, long long idx) const {
    return cols[idx];
  }
};

// Window-local columns (the ranked solve): 128 * base(s, r) + lcols.
template <typename L>
struct RankCols {
  const L* __restrict__ lcols;
  const int* __restrict__ sub_b0;
  const unsigned* __restrict__ sub_dlo;
  const unsigned* __restrict__ sub_dhi;
  __device__ SubTile subtile(long long s) const {
    SubTile t;
    t.s = s;
    t.b0 = sub_b0[s];
    t.lo = sub_dlo[s];
    t.hi = sub_dhi[s];
    return t;
  }
  __device__ long long col(const SubTile& t, int r, long long idx) const {
    return slot_base(t, r, nullptr, 0, 0u) * kSolveLanes +
           (long long)lcols[idx];
  }
};

template <typename Cols>
__global__ void __launch_bounds__(kSolveLanes)
    lower_solve_kernel(const float* __restrict__ vals, Cols cols,
                       const int* __restrict__ chunk_ptr,
                       const float* __restrict__ b_scale, float* x,
                       int* ready, int* ticket, int num_chunks) {
  __shared__ int chunk;
  if (threadIdx.x == 0) chunk = atomicAdd(ticket, 1);
  __syncthreads();
  const int c = chunk;
  if (c >= num_chunks) return;
  const int lane = threadIdx.x;
  float acc = 0.f;
  long long seen = -1;  // the last block this thread saw ready
  const int s1 = chunk_ptr[c + 1];
  for (int s = chunk_ptr[c]; s < s1; ++s) {
    const SubTile t = cols.subtile(s);
#pragma unroll
    for (int r = 0; r < kSolveSublanes; ++r) {
      const long long idx =
          ((long long)s * kSolveSublanes + r) * kSolveLanes + lane;
      const long long col = cols.col(t, r, idx);
      const long long blk = col >> 7;
      if (col < 0 || blk >= c) continue;  // padding
      if (blk != seen) {
        while (load_acquire(ready + blk) == 0) __nanosleep(32);
        seen = blk;
      }
      acc += vals[idx] * __ldcg(x + col);
    }
  }
  const long long row = (long long)c * kSolveLanes + lane;
  __stcg(x + row, b_scale[row] - acc);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) store_release(ready + c, 1);
}

// flags holds ready[num_chunks] and then the ticket. x holds x_blocks
// rows of 128 (num_chunks + 1 for the blocks solve, plus rank_nb guard
// blocks for the ranked one, as the TPU kernels' outputs); rows past the
// chunks stay 0.
template <typename Cols>
int launch_solve(const void* vals, Cols cols, const void* chunk_ptr,
                 const void* b_scale, void* x, void* flags, int num_chunks,
                 long long x_blocks, void* stream) {
  if (num_chunks < 1 || x_blocks <= num_chunks) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(
      x, 0, (size_t)x_blocks * kSolveLanes * sizeof(float), s);
  if (e == cudaSuccess) {
    e = cudaMemsetAsync(flags, 0, ((size_t)num_chunks + 1) * sizeof(int), s);
  }
  if (e != cudaSuccess) return (int)e;
  int* ready = static_cast<int*>(flags);
  lower_solve_kernel<Cols><<<num_chunks, kSolveLanes, 0, s>>>(
      static_cast<const float*>(vals), cols,
      static_cast<const int*>(chunk_ptr), static_cast<const float*>(b_scale),
      static_cast<float*>(x), ready, ready + num_chunks, num_chunks);
  return (int)cudaGetLastError();
}

template <typename L>
int launch_ranked(const void* vals, const void* lcols, const void* sub_b0,
                  const void* sub_dlo, const void* sub_dhi,
                  const void* chunk_ptr, const void* b_scale, void* x,
                  void* flags, int num_chunks, long long x_blocks,
                  void* stream) {
  const RankCols<L> cols{static_cast<const L*>(lcols),
                         static_cast<const int*>(sub_b0),
                         static_cast<const unsigned*>(sub_dlo),
                         static_cast<const unsigned*>(sub_dhi)};
  return launch_solve(vals, cols, chunk_ptr, b_scale, x, flags, num_chunks,
                      x_blocks, stream);
}

}  // namespace

extern "C" int tsp_lower_solve_blocks(const void* vals, const void* cols,
                                      const void* chunk_ptr,
                                      const void* b_scale, void* x,
                                      void* flags, int num_chunks,
                                      long long x_blocks, void* stream) {
  const AbsoluteCols decode{static_cast<const int*>(cols)};
  return launch_solve(vals, decode, chunk_ptr, b_scale, x, flags, num_chunks,
                      x_blocks, stream);
}

// lcol_kind: 0 uint8, 1 int16, 2 int32.
extern "C" int tsp_lower_solve_ranked(int lcol_kind, const void* vals,
                                      const void* lcols, const void* sub_b0,
                                      const void* sub_dlo,
                                      const void* sub_dhi,
                                      const void* chunk_ptr,
                                      const void* b_scale, void* x,
                                      void* flags, int num_chunks,
                                      long long x_blocks, void* stream) {
  switch (lcol_kind) {
    case 0:
      return launch_ranked<uint8_t>(vals, lcols, sub_b0, sub_dlo, sub_dhi,
                                    chunk_ptr, b_scale, x, flags, num_chunks,
                                    x_blocks, stream);
    case 1:
      return launch_ranked<int16_t>(vals, lcols, sub_b0, sub_dlo, sub_dhi,
                                    chunk_ptr, b_scale, x, flags, num_chunks,
                                    x_blocks, stream);
    case 2:
      return launch_ranked<int32_t>(vals, lcols, sub_b0, sub_dlo, sub_dhi,
                                    chunk_ptr, b_scale, x, flags, num_chunks,
                                    x_blocks, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
