// Windowed SpMV and SpMM for Hopper (sm_90a): x (or a row-major X) is
// staged in shared memory by TMA bulk copies, and every gather reads only
// that copy.
//
// Replaces the Pallas kernels
//   tpu_spmv/kernels/dia.py:spmv_dia_windowed (_make_dia_windowed_kernel),
//   tpu_spmv/kernels/pallas_sell.py:spmv_ranked_windowed
//     (_make_windowed_kernel) and its _reduce_partials epilogue,
//   tpu_spmv/kernels/spmm.py:spmm_ranked_windowed
//     (_make_spmm_windowed_kernel) and its per-column segment-sum.
// On the TPU they are the route for an x too large for VMEM: each grid
// step DMAs its tile's x window from HBM into a double-buffered VMEM
// scratch (pallas_sell.py:581-589).
//
// dia_ring_kernel (spmv_dia_windowed): the window is affine in the rows,
// so no table is needed. The rows are cut into steps of S rows (S a
// multiple of 128 that divides the layout's tile, so a step's values are
// D contiguous runs vals[t, k, r0:r0 + S/128, :]), and a persistent CTA
// walks a contiguous range of steps, warp-specialised as the ring walk
// below. One producer warp bulk-copies each step's D value runs into one
// of K = 2 stages and slides x into a ring of W floats (W >= span + K *
// S, span = off_max - off_min): step t adds the S entries of x past step
// t - 1's window (the first step its whole window of S + span), so x is
// read once per CTA run plus one halo. Entry g of x lives in ring slot
// (g + xa - ubase) mod W, where xa aligns the slots to x's 16-byte units;
// a copy that wraps the ring takes two bulk copies; the unaligned ends of
// a range and entries outside [0, n) are written by the warp's lanes
// (plain loads, or 0). Before it reuses a stage (and the ring slots of
// the step that stage held) the producer waits on the stage's empty
// mbarrier, so it runs at most K - 1 steps ahead of the consumers. Eight
// consumer warps read values and x from shared memory only: row i of a
// step reads diagonal k at ring slot (pos0 + i + off_k - off_min + e) mod
// W, pos0 = t * S mod W and e = ubase's distance below the CTA's first
// window, so consecutive threads read consecutive banks; a thread sums
// four rows at once (four independent chains of loads), each over the
// diagonals in ascending offset order with explicit fused multiply-adds
// (csrc/dia.cu's order and operations: spmv_dia_windowed gives
// spmv_dia's bits on one layout), writes y coalesced, and each warp
// releases the step. bf16 values are copied as bytes and widened when
// read.
//
// ring_walk_kernel (spmv_ranked_windowed, B = 1, and spmm_ranked_windowed):
// csrc/sell.cu's segment walk, fed from shared memory by TMA bulk copies
// one step ahead. The layout's window table (formats/sell.window_fields)
// cuts the segments into steps of about 8 sub-tiles and at least 4
// segments, gives each step the x blocks [lo, hi) its slots read (paired
// reads included, the all-pad tail outside every step), the ring size R
// (the most blocks two consecutive steps read together) and the most
// sub-tiles a step holds. Block b of X (128 rows, B columns: one
// contiguous range of a row-major X) lives in ring slot b % R.
//   A persistent CTA walks a contiguous run of steps, warp-specialised.
// One producer warp stages each step into one of two stages: its slabs
// and window bases (contiguous ranges: one bulk copy each) and the x
// blocks it adds to the step before (one copy per range, two where a
// range wraps the ring), all completing on the stage's mbarrier (full);
// the block x ends in and any past it are written by the warp's lanes
// (rows < n with plain loads, the rest 0: a bulk copy moves multiples
// of 16 bytes). Before it stages step t it waits until every consumer
// warp has released step t - 2 (the stage's last step, whose ring slots
// the new blocks may take) on the stage's second mbarrier (empty), or
// step t - 1 too where the two steps span more than R blocks (a window
// that jumps: the whole step is staged then). Nothing assumes lo never
// decreases. Four consumer groups of 128 threads walk the steps with no
// CTA barrier: group g takes the g-th contiguous quarter of a step's
// segments, thread l lane l, reads slabs, bases and x from shared memory
// only, sums a segment's sub-tiles in csrc/sell.cu's order (8 slots of a
// sub-tile by fused multiply-add, then the sub-tile sum into the total),
// so spmv_ranked_windowed gives spmv_ranked's bits on one layout, and
// each warp releases the step. This is the TPU kernel's double buffer,
// two stages deep. A slot reads ring row ((base - lo) * 128 + lcol +
// (lo % R) * 128) mod R * 128, and 0 when (base - lo) * 128 + lcol falls
// outside the step's [0, (hi - lo) * 128). The mbarriers are initialised
// in every launch, so a CUDA graph replays the call with no host work.
//   A chunk of one segment writes its Y rows; a split chunk's segments
// write one partial row each and split_rows_kernel, a second launch,
// adds them in segment order. Columns are walked in groups of at most 8,
// one launch each, the kernel instantiated per width (1 to 8), so B = 5
// does 5 columns of work a slot.
//
// What bounds them: bytes. The slabs (DIA: the diagonal values) stream
// once, by bulk copies that hold no registers, so a CTA keeps a whole
// step in flight (register loads a sub-tile ahead, as csrc/sell.cu's, and
// the first DIA port's per-block window staged with plain loads and one
// barrier, kept too few in flight: PERF.md); x is read once per CTA run
// plus each run's first window, with no partials in device memory. On an
// H100 80GB HBM3 (700 W) the DIA ring moves lap2d_4096's 470 MB in
// 160-165 us, 2.85-2.93 TB/s, where a 400 MB device copy runs at
// 2.92-2.96 (bench/dia_times.py; PERF.md). Shared memory caps the ring
// and the stages: the wrappers refuse more than the card's per-block
// opt-in (for the DIA ring, less its kernel's static bytes:
// tsp_dia_windowed_static_smem).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "split_rows.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kSublanes = 8;

// ---- The ring walk: spmv_ranked_windowed and spmm_ranked_windowed ----

constexpr int kGroups = 4;  // 128-thread consumer groups of a CTA
constexpr int kConsumers = kGroups * kLanes;
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kRingThreads = kConsumers + 32;  // and one producer warp
constexpr int kMaxColumns = 8;                 // columns of X one launch walks
constexpr int kSplitBit = 1 << 30;
constexpr int kSlots = kSublanes * kLanes;  // slots of a sub-tile

__device__ __forceinline__ long long lmin(long long a, long long b) {
  return a < b ? a : b;
}
__device__ __forceinline__ long long lmax(long long a, long long b) {
  return a > b ? a : b;
}
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}
// Adds `bytes` of bulk copies that the current phase waits for.
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// One arrival, releasing this thread's prior writes to the waiters.
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// TMA bulk copy global -> shared, completing `bytes` on the mbarrier.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          long long bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"((unsigned)bytes), "r"(bar)
      : "memory");
}
// Orders this thread's generic writes of shared memory before later bulk
// copies (the async proxy) into the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// A slab value read back from shared memory, widened as csrc/sell.cu's
// load_val does.
__device__ __forceinline__ float stage_val(const float* p) { return *p; }
__device__ __forceinline__ float stage_val(const __nv_bfloat16* p) {
  return __uint_as_float(
      static_cast<unsigned>(*reinterpret_cast<const unsigned short*>(p))
      << 16);
}

template <typename V, typename L>
struct RingArgs {
  const V* vals;
  const L* lcols;
  const int* sub_b0;
  const unsigned* sub_dlo;
  const unsigned* sub_dhi;
  long long num_subtiles;  // S, a multiple of 4
  const int* seg_ptr;
  const int* seg_chunk;
  const int* step_seg;
  const int* step_lo;
  const int* step_hi;
  int num_steps;
  int ring;            // R: blocks of 128 rows of X the ring holds
  int stage_subtiles;  // the most sub-tiles a step holds
  const float* X;
  float* Y;
  float* part;
  long long m, n;
  int B;   // columns of X, Y and part (their row stride)
  int j0;  // the first column this launch walks
};

__host__ __device__ constexpr long long align128(long long b) {
  return (b + 127) / 128 * 128;
}

// One of the two stages of a CTA's shared memory after the ring: a step's
// slabs (values, local columns) and its sub-tiles' window bases (sub_b0
// and the packed deltas, from the 4-aligned sub-tile m0 on, as a bulk
// copy moves 16-byte units).
template <typename V, typename L>
struct Stage {
  V* vals;
  L* lcols;
  int* b0;
  unsigned* dlo;
  unsigned* dhi;

  __host__ __device__ static long long bytes(int cap) {
    return align128((long long)cap * kSlots * sizeof(V)) +
           align128((long long)cap * kSlots * sizeof(L)) +
           3 * align128((long long)(cap + 4) * 4);
  }
  __device__ Stage(unsigned char* base, int cap) {
    vals = reinterpret_cast<V*>(base);
    base += align128((long long)cap * kSlots * sizeof(V));
    lcols = reinterpret_cast<L*>(base);
    base += align128((long long)cap * kSlots * sizeof(L));
    b0 = reinterpret_cast<int*>(base);
    base += align128((long long)(cap + 4) * 4);
    dlo = reinterpret_cast<unsigned*>(base);
    base += align128((long long)(cap + 4) * 4);
    dhi = reinterpret_cast<unsigned*>(base);
  }
};

struct Span {
  long long b0, b1;  // x blocks [b0, b1)
};

// The producer warp's staging of step i into stage `st`, completing on
// the mbarrier `full`: lane 0 announces the bytes, then bulk-copies the
// step's slabs and bases and the x blocks of `nsp` spans that lie wholly
// inside X (the first n / 128) into their ring slots (block b in slot
// b % R: one copy per span, two where it wraps the ring); the 32 lanes
// write the block X ends in and any past it (rows < n with plain loads,
// the rest 0: a bulk copy moves multiples of 16 bytes), fence those
// writes against later bulk copies, and lane 0 arrives once they are
// all done.
template <typename V, typename L>
__device__ void stage_step(const RingArgs<V, L>& a, int i,
                           const Stage<V, L>& st, float* ring,
                           const Span* sp, int nsp, unsigned full) {
  const int lane = threadIdx.x & 31;
  const long long nfull = a.n / kLanes;
  const long long blk = (long long)kLanes * a.B;  // floats per block
  const long long s0 = __ldg(a.seg_ptr + __ldg(a.step_seg + i));
  const long long s1 = __ldg(a.seg_ptr + __ldg(a.step_seg + i + 1));
  const long long m0 = s0 & ~3ll;
  const long long m1 = lmin((s1 + 3) & ~3ll, a.num_subtiles);
  if (lane == 0) {
    long long bytes = (s1 - s0) * kSlots * (long long)(sizeof(V) + sizeof(L)) +
                      3 * (m1 - m0) * 4;
    for (int k = 0; k < nsp; ++k) {
      bytes += lmax(lmin(sp[k].b1, nfull) - sp[k].b0, 0) * blk * 4;
    }
    mbar_expect_tx(full, (unsigned)bytes);
    if (s1 > s0) {
      bulk_copy(st.vals, a.vals + s0 * kSlots, (s1 - s0) * kSlots * sizeof(V),
                full);
      bulk_copy(st.lcols, a.lcols + s0 * kSlots,
                (s1 - s0) * kSlots * sizeof(L), full);
    }
    if (m1 > m0) {
      bulk_copy(st.b0, a.sub_b0 + m0, (m1 - m0) * 4, full);
      bulk_copy(st.dlo, a.sub_dlo + m0, (m1 - m0) * 4, full);
      bulk_copy(st.dhi, a.sub_dhi + m0, (m1 - m0) * 4, full);
    }
    for (int k = 0; k < nsp; ++k) {
      const long long c1 = lmin(sp[k].b1, nfull);
      for (long long b = sp[k].b0; b < c1;) {
        const long long slot = b % a.ring;
        const long long cnt = lmin(c1 - b, a.ring - slot);
        bulk_copy(ring + slot * blk, a.X + b * blk, cnt * blk * 4, full);
        b += cnt;
      }
    }
  }
  bool wrote = false;
  for (int k = 0; k < nsp; ++k) {
    const long long f0 = lmax(sp[k].b0, nfull);
    const long long total = (sp[k].b1 - f0) * blk;
    for (long long e = lane; e < total; e += 32) {
      const long long b = f0 + e / blk;
      const long long w = e - (b - f0) * blk;
      const long long g = b * blk + w;
      ring[(b % a.ring) * blk + w] = g < a.n * a.B ? a.X[g] : 0.f;
      wrote = true;
    }
  }
  if (wrote) fence_proxy_async();
  __syncwarp();
  if (lane == 0) mbar_arrive(full);
}

// Warp-specialised: one producer warp stages each step, the next while
// the consumers walk the current one, into one of two stages (full[k],
// empty[k], k = local step & 1); the consumer groups walk the steps with
// no CTA barrier, each waiting only for its step's data.
//   Producer: step t's blocks may land in ring slots that step t - 2
// reads (two steps that fit the ring together) or step t - 1 (two that
// do not: the whole step is staged once t - 1 is released), and stage
// t & 1 last held step t - 2, so it waits until every consumer warp has
// released those steps (empty), each phase once, in order.
//   Consumers: group g walks the g-th contiguous share of each step's
// segments, thread l lane l, reading slabs, bases and x from shared
// memory only, then each warp releases the step.
// Registers are capped so that two CTAs fit an SM up to 5 columns.
template <typename V, typename L, int NB>
__global__ void __launch_bounds__(kRingThreads, NB <= 5 ? 2 : 1)
    ring_walk_kernel(const RingArgs<V, L> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) unsigned long long bars[4];  // full[2], empty[2]
  const int i0 = (int)((long long)blockIdx.x * a.num_steps / gridDim.x);
  const int i1 = (int)((long long)(blockIdx.x + 1) * a.num_steps / gridDim.x);
  const int nt = i1 - i0;
  if (nt <= 0) return;
  const int R = a.ring;
  float* ring = reinterpret_cast<float*>(smem);
  const long long ring_bytes = align128((long long)R * kLanes * a.B * 4);
  const long long stage_bytes = Stage<V, L>::bytes(a.stage_subtiles);
  // Stage k, full[k] = bars[k], empty[k] = bars[2 + k].
  auto stage = [&](int k) {
    return Stage<V, L>(smem + ring_bytes + k * stage_bytes, a.stage_subtiles);
  };
  const unsigned bar0 = smem_u32(&bars[0]);  // bars[k] at bar0 + 8k
  if (threadIdx.x == 0) {  // every launch: graphs replay it
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    mbar_init(bar0 + 16, kConsumerWarps);
    mbar_init(bar0 + 24, kConsumerWarps);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp
    int released = 0;  // local steps whose release this warp has seen
    int plo = 0, phi = 0;
    for (int t = 0; t < nt; ++t) {
      const int lo = __ldg(a.step_lo + i0 + t);
      const int hi = __ldg(a.step_hi + i0 + t);
      const bool fits = t > 0 && (phi <= plo || hi <= lo ||
                                  max(phi, hi) - min(plo, lo) <= R);
      const int need = fits ? t - 2 : t - 1;
      for (; released <= need; ++released) {
        mbar_wait(bar0 + 16 + 8 * (released & 1), (released >> 1) & 1);
      }
      // The blocks step t adds to step t - 1's, or the whole step.
      const Span add[2] = {{lo, min(hi, plo)}, {max(lo, phi), hi}};
      const Span whole[1] = {{lo, hi}};
      stage_step(a, i0 + t, stage(t & 1), ring, fits ? add : whole,
                 fits ? 2 : 1, bar0 + 8 * (t & 1));
      plo = lo;
      phi = hi;
    }
    return;
  }

  const int g = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int ring_rows = R * kLanes;
  for (int t = 0; t < nt; ++t) {
    const int i = i0 + t;
    const int lo = __ldg(a.step_lo + i);
    const int hi = __ldg(a.step_hi + i);
    const int e0 = __ldg(a.step_seg + i);
    const int ns = __ldg(a.step_seg + i + 1) - e0;
    const int ga = e0 + ns * g / kGroups;
    const int gb = e0 + ns * (g + 1) / kGroups;
    const int first = __ldg(a.seg_ptr + e0);  // the step's first sub-tile
    const int m0 = first & ~3;
    int s = __ldg(a.seg_ptr + ga);
    const int lo_row = (lo % R) * kLanes;  // ring row of block lo, row 0
    const unsigned win_rows = (unsigned)(hi - lo) * kLanes;
    const Stage<V, L> st = stage(t & 1);
    mbar_wait(bar0 + 8 * (t & 1), (t >> 1) & 1);
    for (int seg = ga; seg < gb; ++seg) {
      const int s1 = __ldg(a.seg_ptr + seg + 1);
      float acc[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) acc[j] = 0.f;
      for (; s < s1; ++s) {
        const int k0 = (s - first) * kSlots + lane;
        const int b0 = st.b0[s - m0];
        const unsigned dlo = st.dlo[s - m0];
        const unsigned dhi = st.dhi[s - m0];
        // The 8 slots summed in order with fused multiply-adds, then
        // added to the segment's sum: csrc/sell.cu's order exactly.
        float p[NB];
#pragma unroll
        for (int j = 0; j < NB; ++j) p[j] = 0.f;
#pragma unroll
        for (int r = 0; r < kSublanes; ++r) {
          const float v = stage_val(st.vals + k0 + r * kLanes);
          const int c = st.lcols[k0 + r * kLanes];
          const unsigned word = r < 4 ? dlo : dhi;
          const int base = b0 + (int)((word >> (8 * (r & 3))) & 255u);
          const int off = (base - lo) * kLanes + c;
          const bool inside = (unsigned)off < win_rows;
          int rr = off + lo_row;
          if (rr >= ring_rows) rr -= ring_rows;
          const float* xr = ring + (long long)rr * a.B + a.j0;
#pragma unroll
          for (int j = 0; j < NB; ++j) {
            p[j] = __fmaf_rn(v, inside ? xr[j] : 0.f, p[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < NB; ++j) acc[j] += p[j];
      }
      const int tag = __ldg(a.seg_chunk + seg);
      float* out = nullptr;
      if (tag & kSplitBit) {
        out = a.part + ((long long)(tag & ~kSplitBit) * kLanes + lane) * a.B;
      } else if ((long long)tag * kLanes + lane < a.m) {
        out = a.Y + ((long long)tag * kLanes + lane) * a.B;
      }
      if (out != nullptr) {
#pragma unroll
        for (int j = 0; j < NB; ++j) out[a.j0 + j] = acc[j];
      }
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(bar0 + 16 + 8 * (t & 1));
  }
}

// Opts `kernel` into `bytes` of dynamic shared memory (needed above
// 48 KB) when `bytes` exceeds what this launcher last allowed, which the
// caller keeps in a static of its own: a captured CUDA graph then
// replays no attribute call.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int* allowed) {
  if (bytes <= *allowed) return cudaSuccess;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc == cudaSuccess) *allowed = bytes;
  return rc;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      sms = 0;
    }
  }
  return sms;
}

// The untyped arguments of one call (see tsp_ranked_windowed).
struct RingCall {
  int val_kind, lcol_kind;
  const void *vals, *lcols, *sub_b0, *sub_dlo, *sub_dhi;
  long long num_subtiles;
  const void *seg_ptr, *seg_chunk, *step_seg, *step_lo, *step_hi;
  int num_steps, ring, stage_subtiles;
  const void* X;
  void *Y, *part;
  long long m, n;
  int B;
};

// Launches the walk of columns [j0, j0 + NB) on a persistent grid: as
// many CTAs as fit on the card at once (occupancy at this ring's shared
// memory, counted once per size), at most one per step. With grid != 0
// it only reports that count.
template <typename V, typename L, int NB>
int run_ring(const RingCall& c, int j0, cudaStream_t s, int* grid) {
  static int allowed = 48 * 1024, sized = -1, per_sm = 0;
  const auto kernel = ring_walk_kernel<V, L, NB>;
  const long long bytes = align128((long long)c.ring * kLanes * c.B * 4) +
                          2 * Stage<V, L>::bytes(c.stage_subtiles);
  if (bytes > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int smem = (int)bytes;
  cudaError_t rc = allow_smem(kernel, smem, &allowed);
  if (rc != cudaSuccess) return (int)rc;
  if (smem != sized) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                       kRingThreads, smem);
    if (rc != cudaSuccess) return (int)rc;
    sized = smem;
  }
  const int ctas = sm_count() * per_sm;
  if (ctas < 1) return (int)cudaErrorInvalidConfiguration;
  const int blocks = ctas < c.num_steps ? ctas : c.num_steps;
  if (grid != nullptr) {
    *grid = blocks;
    return 0;
  }
  const RingArgs<V, L> a{
      static_cast<const V*>(c.vals), static_cast<const L*>(c.lcols),
      static_cast<const int*>(c.sub_b0),
      static_cast<const unsigned*>(c.sub_dlo),
      static_cast<const unsigned*>(c.sub_dhi), c.num_subtiles,
      static_cast<const int*>(c.seg_ptr), static_cast<const int*>(c.seg_chunk),
      static_cast<const int*>(c.step_seg), static_cast<const int*>(c.step_lo),
      static_cast<const int*>(c.step_hi), c.num_steps, c.ring,
      c.stage_subtiles,
      static_cast<const float*>(c.X), static_cast<float*>(c.Y),
      static_cast<float*>(c.part), c.m, c.n, c.B, j0};
  kernel<<<(unsigned)blocks, kRingThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// Column tiles: one instance per width 1..8, so B = 5 runs 5 columns of
// work a slot, not 8.
template <typename V, typename L>
int run_columns(const RingCall& c, int j0, int nb, cudaStream_t s,
                int* grid) {
  switch (nb) {
    case 1: return run_ring<V, L, 1>(c, j0, s, grid);
    case 2: return run_ring<V, L, 2>(c, j0, s, grid);
    case 3: return run_ring<V, L, 3>(c, j0, s, grid);
    case 4: return run_ring<V, L, 4>(c, j0, s, grid);
    case 5: return run_ring<V, L, 5>(c, j0, s, grid);
    case 6: return run_ring<V, L, 6>(c, j0, s, grid);
    case 7: return run_ring<V, L, 7>(c, j0, s, grid);
    case 8: return run_ring<V, L, 8>(c, j0, s, grid);
  }
  return (int)cudaErrorInvalidValue;
}

int run_group(const RingCall& c, int j0, int nb, cudaStream_t s, int* grid) {
#define TSP_RING(V, L) return run_columns<V, L>(c, j0, nb, s, grid)
  if (c.val_kind == 0 && c.lcol_kind == 0) TSP_RING(float, uint8_t);
  if (c.val_kind == 0 && c.lcol_kind == 1) TSP_RING(float, int16_t);
  if (c.val_kind == 0 && c.lcol_kind == 2) TSP_RING(float, int32_t);
  if (c.val_kind == 1 && c.lcol_kind == 0) TSP_RING(__nv_bfloat16, uint8_t);
  if (c.val_kind == 1 && c.lcol_kind == 1) TSP_RING(__nv_bfloat16, int16_t);
  if (c.val_kind == 1 && c.lcol_kind == 2) TSP_RING(__nv_bfloat16, int32_t);
#undef TSP_RING
  return (int)cudaErrorInvalidValue;
}
// ---- The DIA ring: spmv_dia_windowed ----

constexpr int kDiaConsumers = 256;  // 8 consumer warps
constexpr int kDiaConsumerWarps = kDiaConsumers / 32;
constexpr int kDiaThreads = kDiaConsumers + 32;  // and one producer warp
constexpr int kDiaStages = 2;  // K (kernels/dia.DIA_STAGES)
constexpr int kDiaRowsAtOnce = 4;  // rows a consumer thread sums together

template <typename V>
struct DiaArgs {
  const V* vals;  // (T, D, rb, 128)
  const int* offs;  // D offsets, ascending
  int D, rb;
  int S;            // rows a step: a multiple of 128 dividing rb * 128
  int W;            // floats of the ring, a multiple of 4
  int stage_bytes;  // one stage: D runs of S values, 128-byte aligned
  int num_steps;    // ceil(m / S)
  const float* x;
  float* y;
  long long m, n;
};

__device__ __forceinline__ long long floor4(long long v) { return v & ~3ll; }

// Persistent and warp-specialised (see the header): CTA b walks steps
// [i0, i1) through K = kDiaStages stages, local step t in stage k = t %
// K: full[k] = bars[k] (the producer's one arrival plus the stage's
// bytes), empty[k] = bars[K + k] (one arrival per consumer warp).
// The producer stages step t once step t - K is released, so it runs at
// most K - 1 steps ahead and the ring, W >= span + K * S floats, holds
// the windows of every step in flight. Shared memory: the ring, K
// stages, and for each diagonal its slot past pos0 (off_k - off_min + e).
template <typename V>
__global__ void __launch_bounds__(kDiaThreads)
    dia_ring_kernel(const DiaArgs<V> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int K = kDiaStages;
  __shared__ __align__(8) unsigned long long bars[2 * K];
  const int i0 = (int)((long long)blockIdx.x * a.num_steps / gridDim.x);
  const int i1 = (int)((long long)(blockIdx.x + 1) * a.num_steps / gridDim.x);
  const int nt = i1 - i0;
  if (nt <= 0) return;
  float* ring = reinterpret_cast<float*>(smem);
  unsigned char* stages = smem + align128((long long)a.W * 4);
  int* dk = reinterpret_cast<int*>(stages + K * (long long)a.stage_bytes);
  const unsigned full0 = smem_u32(&bars[0]);  // full[k] at full0 + 8k
  const unsigned empty0 = smem_u32(&bars[K]);
  if (threadIdx.x == 0) {  // every launch: graphs replay it
    for (int k = 0; k < K; ++k) {
      mbar_init(full0 + 8 * k, 1);
      mbar_init(empty0 + 8 * k, kDiaConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const long long S = a.S, W = a.W;
  // x + g is 16-byte aligned when g + xa is a multiple of 4; entry g
  // lives in ring slot (g + xa - ubase) mod W, ubase = floor4(i0 * S +
  // off_min + xa), a multiple of 4 at or below this CTA's first entry,
  // so aligned entries take aligned slots; e = i0 * S + off_min + xa -
  // ubase.
  const long long xa = (long long)((reinterpret_cast<uintptr_t>(a.x) >> 2) & 3);
  const int off_min = __ldg(a.offs);
  const long long span = __ldg(a.offs + a.D - 1) - off_min;
  const long long ubase = floor4((long long)i0 * S + off_min + xa);
  const int e = (int)((long long)i0 * S + off_min + xa - ubase);
  // The ring slot of entry g: g - ubase + xa lies in [0, 2^31) for every
  // entry of this CTA's run (at most n + span).
  const auto slot = [&](long long g) {
    return (int)((unsigned)(g + xa - ubase) % (unsigned)a.W);
  };
  for (int k = threadIdx.x; k < a.D; k += blockDim.x) {
    dk[k] = __ldg(a.offs + k) - off_min + e;
  }
  __syncthreads();
  const long long rows_per_tile = (long long)a.rb * kLanes;

  if (threadIdx.x >= kDiaConsumers) {  // the producer warp
    const int lane = threadIdx.x & 31;
    // Step t's layout tile, and its first row inside the tile.
    long long tile = (long long)i0 * S / rows_per_tile;
    long long tile_row = (long long)i0 * S - tile * rows_per_tile;
    for (int t = 0; t < nt; ++t) {
      const long long r0 = (long long)(i0 + t) * S;
      // Step t's window is [r0 + off_min, r0 + S + off_min + span); it
      // adds what step t - 1's did not hold, the whole window at t = 0.
      const long long lo = r0 + off_min + (t > 0 ? span : 0);
      const long long hi = r0 + S + off_min + span;
      const int k = t % K, round = t / K;
      if (round > 0) mbar_wait(empty0 + 8 * k, (round - 1) & 1);
      // The aligned part of [lo, hi) inside x, [ga, gb), by bulk copy.
      const long long c0 = lo > 0 ? lo : 0;
      const long long c1 = hi < a.n ? hi : a.n;
      long long ga = hi, gb = hi;
      if (c1 > c0) {
        const long long ua = floor4(c0 + xa + 3), ub = floor4(c1 + xa);
        if (ub > ua) {
          ga = ua - xa;
          gb = ub - xa;
        }
      }
      const unsigned full = full0 + 8 * k;
      V* st = reinterpret_cast<V*>(stages + k * (long long)a.stage_bytes);
      if (lane == 0) {
        const long long run = S * (long long)sizeof(V);
        mbar_expect_tx(full, (unsigned)(a.D * run + (gb - ga) * 4));
        const V* src = a.vals + tile * a.D * rows_per_tile + tile_row;
        for (int d = 0; d < a.D; ++d) {
          bulk_copy(st + d * S, src + d * rows_per_tile, run, full);
        }
        if (gb > ga) {
          const long long p = slot(ga);
          const long long first = lmin(gb - ga, W - p);
          bulk_copy(ring + p, a.x + ga, first * 4, full);
          if (gb - ga > first) {
            bulk_copy(ring, a.x + ga + first, (gb - ga - first) * 4, full);
          }
        }
      }
      // The rest of [lo, hi), [lo, ga) and [gb, hi): plain loads inside
      // x, 0 outside.
      bool wrote = false;
      const auto fill = [&](long long g0, long long g1) {
        for (long long g = g0 + lane; g < g1; g += 32) {
          ring[slot(g)] = (g >= 0 && g < a.n) ? a.x[g] : 0.f;
          wrote = true;
        }
      };
      fill(lo, ga);
      fill(gb, hi);
      if (wrote) fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(full);
      tile_row += S;  // S divides the tile
      if (tile_row == rows_per_tile) {
        tile_row = 0;
        ++tile;
      }
    }
    return;
  }

  // Consumers: thread tid sums rows tid + j * 256 of a step, four at a
  // time, each over the diagonals in ascending order; pos0 = t * S mod W,
  // to which each diagonal adds its slot past it (dk).
  const int tid = threadIdx.x;
  int pos0 = 0;
  for (int t = 0; t < nt; ++t) {
    const long long r0 = (long long)(i0 + t) * S;
    const int k = t % K;
    const V* st =
        reinterpret_cast<const V*>(stages + k * (long long)a.stage_bytes);
    mbar_wait(full0 + 8 * k, (t / K) & 1);
    const int rows = (int)lmin(S, a.m - r0);
    for (int i0r = tid; i0r < rows; i0r += kDiaRowsAtOnce * kDiaConsumers) {
      float acc[kDiaRowsAtOnce];
#pragma unroll
      for (int j = 0; j < kDiaRowsAtOnce; ++j) acc[j] = 0.f;
      for (int d = 0; d < a.D; ++d) {
        const int base = pos0 + dk[d];
        const V* sv = st + d * a.S;
#pragma unroll
        for (int j = 0; j < kDiaRowsAtOnce; ++j) {
          const int i = i0r + j * kDiaConsumers;
          int q = base + i;
          if (q >= a.W) q -= a.W;
          if (i < rows) acc[j] = __fmaf_rn(stage_val(sv + i), ring[q], acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kDiaRowsAtOnce; ++j) {
        const int i = i0r + j * kDiaConsumers;
        if (i < rows) a.y[r0 + i] = acc[j];
      }
    }
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(empty0 + 8 * k);
    pos0 += a.S;  // S < W
    if (pos0 >= a.W) pos0 -= a.W;
  }
}

// Launches the DIA ring on a persistent grid: as many CTAs as fit on the
// card at this shared memory (occupancy counted once per size), at most
// one per step. With grid != 0 it only reports that count.
template <typename V>
int run_dia(const DiaArgs<V>& a, int smem, cudaStream_t s, int* grid) {
  static int allowed = 48 * 1024, sized = -1, per_sm = 0;
  const auto kernel = dia_ring_kernel<V>;
  cudaError_t rc = allow_smem(kernel, smem, &allowed);
  if (rc != cudaSuccess) return (int)rc;
  if (smem != sized) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                       kDiaThreads, smem);
    if (rc != cudaSuccess) return (int)rc;
    sized = smem;
  }
  const int ctas = sm_count() * per_sm;
  if (ctas < 1) return (int)cudaErrorInvalidConfiguration;
  const int blocks = ctas < a.num_steps ? ctas : a.num_steps;
  if (grid != nullptr) {
    *grid = blocks;
    return 0;
  }
  kernel<<<(unsigned)blocks, kDiaThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

int dia_call(int val_kind, const void* vals, const void* offs, int D, int rb,
             int S, int W, int stage_bytes, const void* x, void* y,
             long long m, long long n, int smem, cudaStream_t s, int* grid) {
  // The host sizes the ring (kernels/dia.ring_plan); smem must be the
  // layout this kernel reads, with its own count of stages, and the
  // bulk copies need 16-byte aligned values.
  if (D < 1 || rb < 1 || S < kLanes || S % kLanes || (rb * kLanes) % S ||
      W < kDiaStages * S || W % 4 || stage_bytes < 1 || m < 1 ||
      smem != align128((long long)W * 4) +
                  kDiaStages * (long long)stage_bytes + 4ll * D ||
      reinterpret_cast<uintptr_t>(vals) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const long long steps = (m + S - 1) / S;
  if (steps > 0x7fffffff) return (int)cudaErrorInvalidValue;
#define TSP_DIA(V)                                                        \
  {                                                                       \
    const DiaArgs<V> a{static_cast<const V*>(vals),                       \
                       static_cast<const int*>(offs), D, rb, S, W,        \
                       stage_bytes, (int)steps,                           \
                       static_cast<const float*>(x), static_cast<float*>(y), \
                       m, n};                                             \
    return run_dia(a, smem, s, grid);                                     \
  }
  if (val_kind == 0) TSP_DIA(float);
  if (val_kind == 1) TSP_DIA(__nv_bfloat16);
#undef TSP_DIA
  return (int)cudaErrorInvalidValue;
}
}  // namespace

// Y (m, B) = A @ X (n, B), both row-major, X 16-byte aligned: the ring
// walk of the layout's window table, one launch per group of at most 8
// columns, then, when a chunk is split (num_split > 0), one launch that
// adds the split chunks' partial rows (part: one row of 128 x B floats
// per segment of a split chunk) into Y. val_kind: 0 float32, 1
// bfloat16; lcol_kind: 0 uint8, 1 int16, 2 int32. num_subtiles (S) is
// a multiple of 4; stage_subtiles the most sub-tiles a step holds.
// Shared memory: the ring (ring * 128 * B * 4 bytes), two stages of
// stage_subtiles sub-tiles' slabs and bases, and 4 mbarriers.
extern "C" int tsp_ranked_windowed(
    int val_kind, int lcol_kind, const void* vals, const void* lcols,
    const void* sub_b0, const void* sub_dlo, const void* sub_dhi,
    long long num_subtiles, const void* seg_ptr, const void* seg_chunk,
    const void* split_seg, int num_split, const void* step_seg,
    const void* step_lo, const void* step_hi, int num_steps, int ring,
    int stage_subtiles, const void* X, void* Y, void* part, long long m,
    long long n, int B, void* stream) {
  if (B < 1 || num_steps < 1 || ring < 1 || num_split < 0 ||
      stage_subtiles < 1 || num_subtiles % 4) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RingCall c{val_kind,  lcol_kind, vals,     lcols,     sub_b0,
                   sub_dlo,   sub_dhi,   num_subtiles, seg_ptr, seg_chunk,
                   step_seg,  step_lo,   step_hi,  num_steps, ring,
                   stage_subtiles, X,    Y,        part,      m,
                   n,         B};
  for (int j0 = 0; j0 < B; j0 += kMaxColumns) {
    const int rc = run_group(c, j0, B - j0 < kMaxColumns ? B - j0 : kMaxColumns,
                             s, nullptr);
    if (rc != 0) return rc;
  }
  if (num_split == 0) return 0;
  split_rows_kernel<<<(unsigned)num_split, kLanes, 0, s>>>(
      static_cast<const int*>(split_seg), num_split,
      static_cast<const float*>(part), static_cast<float*>(Y), m, B);
  return (int)cudaGetLastError();
}

// The CTAs each launch of tsp_ranked_windowed runs for this ring, stage
// size and B (its first column group), or minus the CUDA error that
// refuses it.
extern "C" int tsp_ranked_windowed_ctas(int val_kind, int lcol_kind,
                                        int num_steps, int ring,
                                        int stage_subtiles, int B) {
  if (B < 1 || num_steps < 1 || ring < 1 || stage_subtiles < 1) {
    return -(int)cudaErrorInvalidValue;
  }
  RingCall c{};
  c.val_kind = val_kind;
  c.lcol_kind = lcol_kind;
  c.num_steps = num_steps;
  c.ring = ring;
  c.stage_subtiles = stage_subtiles;
  c.B = B;
  int grid = 0;
  const int rc = run_group(c, 0, B < kMaxColumns ? B : kMaxColumns, nullptr,
                           &grid);
  return rc != 0 ? -rc : grid;
}

// y = A @ x for a DIA layout (vals (T, D, rb, 128), D ascending offsets)
// through the ring (see the header). val_kind: 0 float32, 1 bfloat16. S
// rows a step (a multiple of 128 dividing rb * 128), W floats of ring (a
// multiple of 4, at least span + 2S), stage_bytes one stage (D * S
// values, 128-byte aligned); smem = the ring (128-byte aligned), two
// stages and 4 * D bytes of slots.
extern "C" int tsp_spmv_dia_windowed(int val_kind, const void* vals,
                                     const void* offs, int D, int rb, int S,
                                     int W, int stage_bytes, const void* x,
                                     void* y, long long m, long long n,
                                     int smem, void* stream) {
  return dia_call(val_kind, vals, offs, D, rb, S, W, stage_bytes, x, y, m, n,
                  smem, static_cast<cudaStream_t>(stream), nullptr);
}

// The CTAs a launch of tsp_spmv_dia_windowed runs for these sizes, or
// minus the CUDA error that refuses it.
extern "C" int tsp_dia_windowed_ctas(int val_kind, int D, int rb, int S,
                                     int W, int stage_bytes, long long m,
                                     int smem) {
  int grid = 0;
  const int rc = dia_call(val_kind, nullptr, nullptr, D, rb, S, W,
                          stage_bytes, nullptr, nullptr, m, 0, smem, nullptr,
                          &grid);
  return rc != 0 ? -rc : grid;
}

// The static shared memory of the DIA ring's kernel (its mbarriers), the
// most over its value types, or minus the CUDA error: a launch may opt
// into the card's per-block maximum less this.
extern "C" int tsp_dia_windowed_static_smem() {
  cudaFuncAttributes f32{}, bf16{};
  cudaError_t rc = cudaFuncGetAttributes(&f32, dia_ring_kernel<float>);
  if (rc == cudaSuccess) {
    rc = cudaFuncGetAttributes(&bf16, dia_ring_kernel<__nv_bfloat16>);
  }
  if (rc != cudaSuccess) return -(int)rc;
  const size_t most = f32.sharedSizeBytes > bf16.sharedSizeBytes
                          ? f32.sharedSizeBytes
                          : bf16.sharedSizeBytes;
  return (int)most;
}
