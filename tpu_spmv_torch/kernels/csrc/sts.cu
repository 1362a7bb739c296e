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
// lap2d_1024 in level order, 722 on HPCG's 27-point 104^3 grid in
// natural order), so what matters is what one level costs on the chain
// (bench/solve_times.py times a link of the bidiagonal chain and a
// level of the 27-point system; PERF.md). The design keeps everything
// but the solved values themselves off the chain:
//   1. Slabs before waits. A chunk's slab loads depend on no other
//      chunk, and a CTA takes its ticket long before its producers
//      finish (hundreds of CTAs are resident, a few chunks a level). So
//      after the ticket each thread loads b_scale and the values and
//      columns of its chunk's first group of kGroup sub-tiles (for the
//      ranked kernel, their decoded window bases too) into registers,
//      and marks padding slots (block >= c, or a negative column),
//      which gather nothing; one thread each bulk-prefetches the rest of
//      a longer chunk's values and columns into L2.
//   2. The value is the flag. Before the kernel, the chunks' rows of x
//      are set to the sentinel bit pattern 0xFFFFFFFF. A thread issues
//      its group's gathers back to back and then re-reads, in rounds
//      with __nanosleep back-off between them, only the slots that
//      still read the sentinel. A ready producer costs one L2 round
//      trip: no flag, no barrier, no second read.
//   3. One gather round trip a group. The next group's slab loads are
//      issued behind the group's gathers, then the group's products are
//      summed with explicit fused multiply-adds in a fixed slot order,
//      so two calls (and two replays of a captured call) give the same
//      bits, and the plain version repeats them exactly. A chunk of at
//      most kGroup sub-tiles (every chunk of lap2d_1024 and lap3d_101 in
//      level order) is one round trip.
//      Branches on a group's size are uniform over the CTA, so a chunk
//      shorter than kGroup issues nothing for the sub-tiles it lacks.
//   4. The write: each thread stores its own row, b - acc, as soon as
//      its sum is done. No barrier and no release: the chunk publishes
//      row by row.
// The memory model. Each row of x is one 32-bit word, written once by
// one thread (st.relaxed.gpu) and read by consumers with ld.relaxed.gpu:
// strong operations at gpu scope on one location are coherent, so a
// consumer reads either the sentinel or the final value, never a stale
// L1 line, and a read of the new bits is the data itself, with nothing
// else to publish. So no fence, no release/acquire pair and no barrier
// sit on the chain; the only barrier is the ticket's, at the start. The
// sentinel cannot be produced by the solve: on sm_90 add, sub and fma
// return the canonical NaN 0x7FFFFFFF for a NaN result (a NaN b does
// not pass through with its bits), and the store maps the one pattern
// to the canonical NaN besides, so a NaN, inf or sentinel-patterned b
// gives a NaN row, never a row that reads as unsolved. Guard blocks
// past the chunks are zeroed, not set to the sentinel: padding slots
// that read them go through without waiting.
// Deadlock: a chunk reads only rows of chunks < c, each handed by the
// ticket to a CTA that was already running, which reads only earlier
// chunks in turn; so chunk 0's CTA finishes and the waits unwind.
//
// The poll traffic is the design's cost: ~2,000 CTAs can be resident,
// ~160 levels ahead of the frontier on HPCG's grid, so nearly every
// first read of a level-scheduled system finds the sentinel. Two
// throttles were timed on an H100 (bench/solve_times.py, a link of the
// bidiagonal chain / a level of HPCG's 104^3 IC(0) factor, ranked
// kernel): (a) every waiting slot each round, with back-off, 0.494 /
// 0.762 us; (b) the slot of the latest producer (the largest column)
// alone until it is in, then the rest, 0.725 / 1.629 us. (a) is kept. Its back-off: 0, 32, 64,
// 128, 256 ns gave 0.722, 0.712, 0.719, 0.772, 0.893 us a level (0.457
// to 0.531 us a link); 32 ns is kept (PERF.md).
//
// What each earlier step was worth, and what was tried and dropped
// (groups of 4 sub-tiles at 158 registers a thread, slabs staged in
// shared memory), is in PERF.md.
// Where the layout has many sub-tiles a chunk (banded_1m's
// column-binned ranked layout: a median of 7, against 2 for its blocks
// layout) the walk is bound by its slab rounds, not the chain.
//
// Each call sets the chunks' rows of x to the sentinel and zeroes the
// guard blocks past them and the ticket, with cudaMemsetAsync on its
// own stream, so a CUDA graph that captures a call replays all of it
// (replay freezes the arguments; nothing else needs resetting).
//
// A counting instantiation (kCount, launched only when the caller
// passes a counter array; bench/solve_times.py) adds, per solve, the
// slots read (those not marked as padding), those whose first read
// found the sentinel, and the re-reads those took. The instantiation
// the solvers run compiles the counting out.

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
// The poll's back-off between re-reads of a waiting slot.
constexpr unsigned kSleepNs = 32;
// What an unsolved row of x reads: no float operation yields it (see
// the header).
constexpr unsigned kSentinel = 0xFFFFFFFFu;
constexpr unsigned kCanonicalNan = 0x7FFFFFFFu;
// The counting instantiation's counters: slots read, first reads that
// found the sentinel, re-reads.
constexpr int kCounters = 3;

__device__ __forceinline__ unsigned load_relaxed(const float* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void store_relaxed(float* p, float v) {
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;" ::"l"(p),
               "r"(__float_as_uint(v))
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

// The group's gathers, issued back to back: x's bits at each slot read,
// 0 at a slot marked as padding. Slots past the chunk (p >= n) are not touched.
__device__ __forceinline__ void gather_group(
    const float* x, const Slots (&g)[kGroup], int n,
    unsigned (&xb)[kGroup][kSolveSublanes]) {
#pragma unroll
  for (int p = 0; p < kGroup; ++p) {
    if (p < n) {
#pragma unroll
      for (int r = 0; r < kSolveSublanes; ++r) {
        xb[p][r] = g[p].col[r] >= 0 ? load_relaxed(x + g[p].col[r]) : 0u;
      }
    }
  }
}

// Until no slot of the group reads the sentinel: each round re-reads
// every slot still waiting, back to back; rounds after the first back
// off first.
template <bool kCount>
__device__ __forceinline__ void wait_group(
    const float* x, const Slots (&g)[kGroup], int n,
    unsigned (&xb)[kGroup][kSolveSublanes], unsigned (&count)[kCounters]) {
  if (kCount) {
#pragma unroll
    for (int p = 0; p < kGroup; ++p) {
      if (p < n) {
#pragma unroll
        for (int r = 0; r < kSolveSublanes; ++r) {
          count[0] += g[p].col[r] >= 0;
          count[1] += xb[p][r] == kSentinel;
        }
      }
    }
  }
  for (int round = 0;; ++round) {
    bool waiting = false;
#pragma unroll
    for (int p = 0; p < kGroup; ++p) {
      if (p < n) {
#pragma unroll
        for (int r = 0; r < kSolveSublanes; ++r) {
          waiting |= xb[p][r] == kSentinel;
        }
      }
    }
    if (!waiting) return;
    if (round > 0) __nanosleep(kSleepNs);
#pragma unroll
    for (int p = 0; p < kGroup; ++p) {
      if (p < n) {
#pragma unroll
        for (int r = 0; r < kSolveSublanes; ++r) {
          if (xb[p][r] == kSentinel) {
            xb[p][r] = load_relaxed(x + g[p].col[r]);
            if (kCount) ++count[2];
          }
        }
      }
    }
  }
}

template <typename Cols, bool kCount>
__global__ void __launch_bounds__(kSolveLanes)
    lower_solve_kernel(const float* __restrict__ vals, Cols cols,
                       const int* __restrict__ chunk_ptr,
                       const float* __restrict__ b_scale, float* x,
                       int* ticket, int num_chunks,
                       unsigned long long* counters) {
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

  // 2-3. Group by group: the group's gathers, the next group's slab
  // loads behind them, the wait on the slots that read the sentinel,
  // then the group's sum in slot order. A chunk of at most kGroup
  // sub-tiles is one gather round trip when its producers are done.
  unsigned count[kCounters] = {0u, 0u, 0u};
  float acc = 0.f;
  for (int s = s0; s < s1; s += kGroup) {
    unsigned xb[kGroup][kSolveSublanes];
    gather_group(x, g, s1 - s, xb);
    Slots next[kGroup];
    load_group(vals, cols, s + kGroup, s1, c, lane, next);
    wait_group<kCount>(x, g, s1 - s, xb, count);
#pragma unroll
    for (int p = 0; p < kGroup; ++p) {
      if (s + p < s1) {
#pragma unroll
        for (int r = 0; r < kSolveSublanes; ++r) {
          acc = __fmaf_rn(g[p].v[r], __uint_as_float(xb[p][r]), acc);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kGroup; ++p) g[p] = next[p];
  }

  // 4. The row: its value is its ready flag.
  float out = __fsub_rn(b, acc);
  if (__float_as_uint(out) == kSentinel) out = __uint_as_float(kCanonicalNan);
  store_relaxed(x + row, out);

  if (kCount) {
#pragma unroll
    for (int i = 0; i < kCounters; ++i) {
      const unsigned warp = __reduce_add_sync(0xFFFFFFFFu, count[i]);
      if (lane % kWarpSize == 0 && warp) atomicAdd(counters + i, warp);
    }
  }
}

// x holds x_blocks rows of 128 (num_chunks + 1 for the blocks solve,
// plus rank_nb guard blocks for the ranked one, as the TPU kernels'
// outputs) and then one int32 word, the ticket. The chunks' rows are
// set to the sentinel here and written by the kernel; the rows past the
// chunks and the ticket, contiguous, are zeroed. counters: null, or
// kCounters uint64 that the counting instantiation adds to.
template <typename Cols>
int launch_solve(const void* vals, Cols cols, const void* chunk_ptr,
                 const void* b_scale, void* x, void* counters,
                 int num_chunks, long long x_blocks, void* stream) {
  if (num_chunks < 1 || x_blocks <= num_chunks) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* xf = static_cast<float*>(x);
  const long long chunk_rows = (long long)num_chunks * kSolveLanes;
  const long long x_rows = x_blocks * kSolveLanes;
  cudaError_t e = cudaMemsetAsync(xf, 0xFF, (size_t)chunk_rows * sizeof(float), s);
  if (e == cudaSuccess) {
    e = cudaMemsetAsync(xf + chunk_rows, 0,
                        (size_t)(x_rows - chunk_rows + 1) * sizeof(float), s);
  }
  if (e != cudaSuccess) return (int)e;
  int* ticket = reinterpret_cast<int*>(xf + x_rows);
  auto* count = static_cast<unsigned long long*>(counters);
  if (count == nullptr) {
    lower_solve_kernel<Cols, false><<<num_chunks, kSolveLanes, 0, s>>>(
        static_cast<const float*>(vals), cols,
        static_cast<const int*>(chunk_ptr),
        static_cast<const float*>(b_scale), xf, ticket, num_chunks, count);
  } else {
    lower_solve_kernel<Cols, true><<<num_chunks, kSolveLanes, 0, s>>>(
        static_cast<const float*>(vals), cols,
        static_cast<const int*>(chunk_ptr),
        static_cast<const float*>(b_scale), xf, ticket, num_chunks, count);
  }
  return (int)cudaGetLastError();
}

template <typename L>
int launch_ranked(const void* vals, const void* lcols, const void* sub_b0,
                  const void* sub_dlo, const void* sub_dhi,
                  const void* chunk_ptr, const void* b_scale, void* x,
                  void* counters, int num_chunks, long long x_blocks,
                  void* stream) {
  const RankCols<L> cols{static_cast<const L*>(lcols),
                         static_cast<const int*>(sub_b0),
                         static_cast<const unsigned*>(sub_dlo),
                         static_cast<const unsigned*>(sub_dhi)};
  return launch_solve(vals, cols, chunk_ptr, b_scale, x, counters,
                      num_chunks, x_blocks, stream);
}

}  // namespace

extern "C" int tsp_lower_solve_blocks(const void* vals, const void* cols,
                                      const void* chunk_ptr,
                                      const void* b_scale, void* x,
                                      void* counters, int num_chunks,
                                      long long x_blocks, void* stream) {
  const AbsoluteCols decode{static_cast<const int*>(cols)};
  return launch_solve(vals, decode, chunk_ptr, b_scale, x, counters,
                      num_chunks, x_blocks, stream);
}

// lcol_kind: 0 uint8, 1 int16, 2 int32.
extern "C" int tsp_lower_solve_ranked(int lcol_kind, const void* vals,
                                      const void* lcols, const void* sub_b0,
                                      const void* sub_dlo,
                                      const void* sub_dhi,
                                      const void* chunk_ptr,
                                      const void* b_scale, void* x,
                                      void* counters, int num_chunks,
                                      long long x_blocks, void* stream) {
#define TSP_SOLVE_RANKED(L)                                                  \
  return launch_ranked<L>(vals, lcols, sub_b0, sub_dlo, sub_dhi, chunk_ptr, \
                          b_scale, x, counters, num_chunks, x_blocks, stream)
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
