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
// one CTA of 128 threads solves one chunk, a thread per row (lane), and
// takes its chunk from a global ticket (atomicAdd by thread 0), not from
// blockIdx: CUDA does not start blocks in blockIdx order. With tickets,
// every chunk a CTA waits on was handed to a CTA that is already
// running, so the waits cannot deadlock.
//
// What bounds it: latency along the chain of dependencies, not bytes.
// The time follows the chunk-level dependency depth (1024 levels on
// lap2d_1024 in level order), so what matters is what one level costs
// on the chain: on an H100 about 1 us, the cost of one link of a
// bidiagonal chain (bench/solve_times.py, PERF.md). The design keeps
// everything else off the chain:
//   1. Slabs before waits. A chunk's slab loads depend on no other
//      chunk, and a CTA takes its ticket long before its producers
//      finish (hundreds of CTAs are resident, a few chunks a level). So
//      after the ticket each thread loads b_scale and the values and
//      columns of its chunk's first group of kGroup sub-tiles (for the
//      ranked kernel, their decoded window bases too) into registers,
//      and marks padding slots (block >= c, or a negative column),
//      which gather nothing; one thread each bulk-prefetches the rest of
//      a longer chunk's values and columns into L2. Only then does the
//      CTA wait.
//   2. One wait per producer. The layout's wait table (formats/sell.
//      wait_fields: wait_ptr, wait_chunk) lists the distinct earlier
//      chunks that chunk c's slots read, latest first. The CTA's threads
//      take one entry each, 128 at a time, each spinning on one ready
//      flag: polling traffic in L2 is a thread per producer, not a
//      thread per slot.
//   3. One gather round trip a group. After the barrier, the group's x
//      loads are issued back to back, the next group's slab loads behind
//      them, then the group's products are summed in a fixed slot order,
//      so two calls (and two replays of a captured call) give the same
//      bits. A chunk of at most kGroup sub-tiles (every chunk of
//      lap2d_1024 and lap3d_101 in level order) is one round trip.
//      Branches on a group's size are uniform over the CTA, so a chunk
//      shorter than kGroup issues nothing for the sub-tiles it lacks.
//   4. The write, one release per CTA: __stcg of the row, a barrier,
//      and thread 0's st.release.gpu of ready[c].
// The memory-model chain that makes a producer's rows visible to the
// consumer's gathers: producer threads' __stcg(x) -> bar.sync ->
// producer thread 0's st.release.gpu(ready[b]) -> a consumer thread's
// ld.acquire.gpu(ready[b]) that reads 1 -> __syncwarp, bar.sync -> the
// consumer threads' x loads, which go to L2 (ld.global.cg, __ldcg) and
// never through L1, which is not coherent across SMs. (CUTLASS's
// semaphore uses the same barrier-then-release pair.)
//
// What each step was worth, and what was tried and dropped (groups of 4
// sub-tiles at 158 registers a thread, slabs staged in shared memory),
// is in PERF.md. Where the layout has many sub-tiles a chunk
// (banded_1m's column-binned ranked layout: a median of 7, against 2
// for its blocks layout) the walk is bound by its slab rounds, not the
// chain.
//
// Each call zeroes the flags and the ticket, and the guard blocks of x
// past the chunks (every row of every chunk is written by its CTA), with
// cudaMemsetAsync on its own stream, so a CUDA graph that captures a
// call replays all of it (replay freezes the arguments; nothing else
// needs resetting).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSolveLanes = 128;
constexpr int kSolveSublanes = 8;
// Sub-tiles a group: the unit of one gather round trip (PERF.md: 1 lost
// on banded_1m and the blocks chain, 4 everywhere, at 158 registers a
// thread).
constexpr int kGroup = 2;
constexpr int kWarpSize = 32;
// The poll's back-off: spinning without it, or with 128 ns, was slower
// on the chain (PERF.md).
constexpr unsigned kSleepNs = 32;

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

// Hopper's bulk prefetch of `bytes` (a multiple of 16, from a 16-byte
// aligned address) into L2, issued by one thread: no registers held.
__device__ __forceinline__ void prefetch_l2(const void* p, unsigned bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(p),
               "r"(bytes));
}

// One sub-tile of one lane: 8 values and 8 absolute columns, -1 for a
// slot that gathers nothing.
struct Slots {
  float v[kSolveSublanes];
  int col[kSolveSublanes];
};

// Absolute int32 columns (lower_solve_blocks).
struct AbsoluteCols {
  const int* __restrict__ cols;
  // Sub-tiles [s, s + n) of the columns into L2.
  __device__ __forceinline__ void prefetch(int s, int n) const {
    prefetch_l2(cols + (long long)s * kSolveSublanes * kSolveLanes,
                (unsigned)n * kSolveSublanes * kSolveLanes * sizeof(int));
  }
  __device__ __forceinline__ void load(int, long long k0,
                                       int (&col)[kSolveSublanes]) const {
#pragma unroll
    for (int r = 0; r < kSolveSublanes; ++r) {
      col[r] = __ldcs(cols + k0 + r * kSolveLanes);
    }
  }
};

// Window-local columns (the ranked solve): 128 * base(s, r) + lcols,
// base(s, r) = sub_b0[s] + byte r of sub_dlo (r < 4) / sub_dhi (r >= 4),
// decoded as uint32 with logical shifts (a signed shift would
// sign-extend a byte >= 128).
template <typename L>
struct RankCols {
  const L* __restrict__ lcols;
  const int* __restrict__ sub_b0;
  const unsigned* __restrict__ sub_dlo;
  const unsigned* __restrict__ sub_dhi;
  __device__ __forceinline__ void prefetch(int s, int n) const {
    prefetch_l2(lcols + (long long)s * kSolveSublanes * kSolveLanes,
                (unsigned)n * kSolveSublanes * kSolveLanes * sizeof(L));
  }
  __device__ __forceinline__ void load(int s, long long k0,
                                       int (&col)[kSolveSublanes]) const {
    const int b0 = __ldg(sub_b0 + s);
    const unsigned lo = __ldg(sub_dlo + s);
    const unsigned hi = __ldg(sub_dhi + s);
#pragma unroll
    for (int r = 0; r < kSolveSublanes; ++r) {
      const unsigned word = r < 4 ? lo : hi;
      const int base = b0 + (int)((word >> (8 * (r & 3))) & 255u);
      col[r] = base * kSolveLanes + (int)__ldcs(lcols + k0 + r * kSolveLanes);
    }
  }
};

// Lane `lane`'s slots of sub-tile s of chunk c, padding marked.
template <typename Cols>
__device__ __forceinline__ void load_slots(const float* __restrict__ vals,
                                           const Cols& cols, int s, int c,
                                           int lane, Slots& t) {
  const long long k0 = (long long)s * kSolveSublanes * kSolveLanes + lane;
  cols.load(s, k0, t.col);
#pragma unroll
  for (int r = 0; r < kSolveSublanes; ++r) {
    t.v[r] = __ldcs(vals + k0 + r * kSolveLanes);
  }
  // A real slot of value 0 still gathers: the plain version's 0 * x
  // carries an inf or NaN of x.
#pragma unroll
  for (int r = 0; r < kSolveSublanes; ++r) {
    if (t.col[r] < 0 || (t.col[r] >> 7) >= c) t.col[r] = -1;
  }
}

__device__ __forceinline__ float gather(const float* x, int col) {
  return col >= 0 ? __ldcg(x + col) : 0.f;
}

// A group: up to kGroup consecutive sub-tiles of the chunk, the unit of
// one gather round trip. Every branch on a group's size is the same for
// the whole CTA (s, s1 are the chunk's), so a sub-tile past the chunk
// costs no instruction, where a predicated slot would still issue one.
template <typename Cols>
__device__ __forceinline__ void load_group(const float* __restrict__ vals,
                                           const Cols& cols, int s, int s1,
                                           int c, int lane,
                                           Slots (&g)[kGroup]) {
#pragma unroll
  for (int p = 0; p < kGroup; ++p) {
    if (s + p < s1) load_slots(vals, cols, s + p, c, lane, g[p]);
  }
}

template <typename Cols>
__global__ void __launch_bounds__(kSolveLanes)
    lower_solve_kernel(const float* __restrict__ vals, Cols cols,
                       const int* __restrict__ chunk_ptr,
                       const int* __restrict__ wait_ptr,
                       const int* __restrict__ wait_chunk,
                       const float* __restrict__ b_scale, float* x,
                       int* ready, int* ticket, int num_chunks) {
  __shared__ int chunk;
  if (threadIdx.x == 0) chunk = atomicAdd(ticket, 1);
  __syncthreads();
  const int c = chunk;
  if (c >= num_chunks) return;
  const int lane = threadIdx.x;
  const long long row = (long long)c * kSolveLanes + lane;
  const int s0 = __ldg(chunk_ptr + c);
  const int s1 = __ldg(chunk_ptr + c + 1);

  // 1. Everything of this chunk's own, before any wait: b and the first
  // group's slabs.
  const float b = __ldg(b_scale + row);
  Slots g[kGroup];
  load_group(vals, cols, s0, s1, c, lane, g);
  // The rest of a longer chunk's slabs, into L2 (one thread each).
  const int rest = s1 - s0 - kGroup;
  if (rest > 0) {
    if (lane == 0) {
      prefetch_l2(vals + (long long)(s0 + kGroup) * kSolveSublanes *
                             kSolveLanes,
                  (unsigned)rest * kSolveSublanes * kSolveLanes *
                      sizeof(float));
    } else if (lane == kWarpSize) {
      cols.prefetch(s0 + kGroup, rest);
    }
  }

  // 2. Each producer chunk waited on once, by one thread; the barrier
  // releases the CTA.
  const int w1 = __ldg(wait_ptr + c + 1);
  for (int i = __ldg(wait_ptr + c) + lane; i < w1; i += kSolveLanes) {
    const int* flag = ready + __ldg(wait_chunk + i);
    while (load_acquire(flag) == 0) __nanosleep(kSleepNs);
  }
  __syncwarp();
  __syncthreads();

  // 3. Group by group: all of the group's gathers back to back, the
  // next group's slab loads behind them, then the group's sum in slot
  // order. A chunk of at most kGroup sub-tiles (every chunk of
  // lap2d_1024 and lap3d_101) is one gather round trip.
  float acc = 0.f;
  for (int s = s0; s < s1; s += kGroup) {
    float xv[kGroup][kSolveSublanes];
#pragma unroll
    for (int p = 0; p < kGroup; ++p) {
      if (s + p < s1) {
#pragma unroll
        for (int r = 0; r < kSolveSublanes; ++r) {
          xv[p][r] = gather(x, g[p].col[r]);
        }
      }
    }
    Slots next[kGroup];
    load_group(vals, cols, s + kGroup, s1, c, lane, next);
#pragma unroll
    for (int p = 0; p < kGroup; ++p) {
      if (s + p < s1) {
#pragma unroll
        for (int r = 0; r < kSolveSublanes; ++r) acc += g[p].v[r] * xv[p][r];
      }
    }
#pragma unroll
    for (int p = 0; p < kGroup; ++p) g[p] = next[p];
  }

  // 4. The row, then one release for the chunk.
  __stcg(x + row, b - acc);
  __syncthreads();
  if (threadIdx.x == 0) store_release(ready + c, 1);
}

// flags holds ready[num_chunks] and then the ticket. x holds x_blocks
// rows of 128 (num_chunks + 1 for the blocks solve, plus rank_nb guard
// blocks for the ranked one, as the TPU kernels' outputs); the rows past
// the chunks are zeroed here, the chunks' rows written by the kernel.
template <typename Cols>
int launch_solve(const void* vals, Cols cols, const void* chunk_ptr,
                 const void* wait_ptr, const void* wait_chunk,
                 const void* b_scale, void* x, void* flags, int num_chunks,
                 long long x_blocks, void* stream) {
  if (num_chunks < 1 || x_blocks <= num_chunks) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* xf = static_cast<float*>(x);
  const long long chunk_rows = (long long)num_chunks * kSolveLanes;
  cudaError_t e = cudaMemsetAsync(
      xf + chunk_rows, 0,
      (size_t)(x_blocks * kSolveLanes - chunk_rows) * sizeof(float), s);
  if (e == cudaSuccess) {
    e = cudaMemsetAsync(flags, 0, ((size_t)num_chunks + 1) * sizeof(int), s);
  }
  if (e != cudaSuccess) return (int)e;
  int* ready = static_cast<int*>(flags);
  lower_solve_kernel<Cols><<<num_chunks, kSolveLanes, 0, s>>>(
      static_cast<const float*>(vals), cols,
      static_cast<const int*>(chunk_ptr), static_cast<const int*>(wait_ptr),
      static_cast<const int*>(wait_chunk), static_cast<const float*>(b_scale),
      xf, ready, ready + num_chunks, num_chunks);
  return (int)cudaGetLastError();
}

template <typename L>
int launch_ranked(const void* vals, const void* lcols, const void* sub_b0,
                  const void* sub_dlo, const void* sub_dhi,
                  const void* chunk_ptr, const void* wait_ptr,
                  const void* wait_chunk, const void* b_scale, void* x,
                  void* flags, int num_chunks, long long x_blocks,
                  void* stream) {
  const RankCols<L> cols{static_cast<const L*>(lcols),
                         static_cast<const int*>(sub_b0),
                         static_cast<const unsigned*>(sub_dlo),
                         static_cast<const unsigned*>(sub_dhi)};
  return launch_solve(vals, cols, chunk_ptr, wait_ptr, wait_chunk, b_scale,
                      x, flags, num_chunks, x_blocks, stream);
}

}  // namespace

extern "C" int tsp_lower_solve_blocks(const void* vals, const void* cols,
                                      const void* chunk_ptr,
                                      const void* wait_ptr,
                                      const void* wait_chunk,
                                      const void* b_scale, void* x,
                                      void* flags, int num_chunks,
                                      long long x_blocks, void* stream) {
  const AbsoluteCols decode{static_cast<const int*>(cols)};
  return launch_solve(vals, decode, chunk_ptr, wait_ptr, wait_chunk, b_scale,
                      x, flags, num_chunks, x_blocks, stream);
}

// lcol_kind: 0 uint8, 1 int16, 2 int32.
extern "C" int tsp_lower_solve_ranked(int lcol_kind, const void* vals,
                                      const void* lcols, const void* sub_b0,
                                      const void* sub_dlo,
                                      const void* sub_dhi,
                                      const void* chunk_ptr,
                                      const void* wait_ptr,
                                      const void* wait_chunk,
                                      const void* b_scale, void* x,
                                      void* flags, int num_chunks,
                                      long long x_blocks, void* stream) {
#define TSP_SOLVE_RANKED(L)                                                  \
  return launch_ranked<L>(vals, lcols, sub_b0, sub_dlo, sub_dhi, chunk_ptr, \
                          wait_ptr, wait_chunk, b_scale, x, flags,          \
                          num_chunks, x_blocks, stream)
  switch (lcol_kind) {
    case 0:
      TSP_SOLVE_RANKED(uint8_t);
    case 1:
      TSP_SOLVE_RANKED(int16_t);
    case 2:
      TSP_SOLVE_RANKED(int32_t);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TSP_SOLVE_RANKED
}
