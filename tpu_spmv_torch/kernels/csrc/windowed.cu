// Windowed SpMV and SpMM for Hopper (sm_90a): x (or a row-major X) is
// staged in shared memory, and every gather reads only that copy.
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
// dia_windowed_kernel: the window is affine in the row range (no
// metadata), so a block owns `rows_per_cta` rows, fewer than a layout
// tile, and stages x[r0 + off_min, r0 + rows + off_max) with plain
// cooperative loads and one __syncthreads() (entries outside [0, n) as
// 0). Every block re-reads the halo (off_max - off_min entries); the
// wrapper sizes rows_per_cta so the halo is a small share
// (kernels/dia.py). One thread per row, diagonals added in ascending
// offset order, as csrc/dia.cu.
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
// What bounds them: bytes. The slabs stream once, by bulk copies that
// hold no registers, so a CTA keeps a whole step in flight (register
// loads a sub-tile ahead, as csrc/sell.cu's, kept too few in flight:
// PERF.md); X is read once per CTA run plus each run's first window,
// with no per-sub-tile partials in device memory. Shared memory caps the ring and the stages: the wrapper
// refuses more than device_spec().smem_per_block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 128;
constexpr int kSublanes = 8;
constexpr int kDiaThreads = 512;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// win[i] = src[first + i] for i < count, 0 where first + i lies outside
// [0, limit); then a barrier, so the whole window is visible.
__device__ __forceinline__ void stage(float* win, const float* __restrict__ src,
                                      long long first, long long count,
                                      long long limit) {
  for (long long i = threadIdx.x; i < count; i += blockDim.x) {
    const long long g = first + i;
    win[i] = (g >= 0 && g < limit) ? src[g] : 0.f;
  }
  __syncthreads();
}

template <typename V>
__global__ void __launch_bounds__(kDiaThreads)
    dia_windowed_kernel(const V* __restrict__ vals,
                        const int* __restrict__ offs, int D, int rb,
                        int off_min, int span, int rows_per_cta,
                        const float* __restrict__ x, float* __restrict__ y,
                        long long m, long long n) {
  extern __shared__ float win[];
  const long long r0 = (long long)blockIdx.x * rows_per_cta;
  const long long left = m - r0;
  const long long rows = left < rows_per_cta ? left : rows_per_cta;
  stage(win, x, r0 + off_min, rows + span, n);
  const long long stride = (long long)rb * kLanes;  // one diagonal of a tile
  for (long long i = threadIdx.x; i < rows; i += blockDim.x) {
    const long long row = r0 + i;
    const long long blk = row >> 7;
    const long long t = blk / rb;
    const long long r = blk - t * rb;
    const V* v = vals + t * D * stride + r * kLanes + (row & 127);
    float acc = 0.f;
    for (int k = 0; k < D; ++k) {
      acc += widen(v[k * stride]) * win[i + offs[k] - off_min];
    }
    y[row] = acc;
  }
}

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

// Y rows of every split chunk: its segments' partial rows added in
// segment order, column by column (csrc/sell.cu's fix-up, B columns
// wide). One block of 128 threads per split chunk; split_seg is (3, K):
// the chunk, its first partial row and one past its last.
__global__ void __launch_bounds__(kLanes)
    split_rows_kernel(const int* __restrict__ split_seg, int num_split,
                      const float* __restrict__ part, float* __restrict__ Y,
                      long long m, int B) {
  const int lane = threadIdx.x;
  const int c = __ldg(split_seg + blockIdx.x);
  const int p0 = __ldg(split_seg + num_split + blockIdx.x);
  const int p1 = __ldg(split_seg + 2 * num_split + blockIdx.x);
  const long long row = (long long)c * kLanes + lane;
  if (row >= m) return;
  for (int j = 0; j < B; ++j) {
    float acc = 0.f;
    for (int p = p0; p < p1; ++p) {
      acc += part[((long long)p * kLanes + lane) * B + j];
    }
    Y[row * B + j] = acc;
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

template <typename V>
int launch_dia(const void* vals, const void* offs, int D, int rb,
               int off_min, int span, int rows_per_cta, const void* x,
               void* y, long long m, long long n, int smem, cudaStream_t s) {
  static int allowed = 48 * 1024;
  const cudaError_t rc = allow_smem(dia_windowed_kernel<V>, smem, &allowed);
  if (rc != cudaSuccess) return (int)rc;
  const unsigned blocks = (unsigned)((m + rows_per_cta - 1) / rows_per_cta);
  dia_windowed_kernel<V><<<blocks, kDiaThreads, smem, s>>>(
      static_cast<const V*>(vals), static_cast<const int*>(offs), D, rb,
      off_min, span, rows_per_cta, static_cast<const float*>(x),
      static_cast<float*>(y), m, n);
  return (int)cudaGetLastError();
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
}  // namespace

// val_kind: 0 float32, 1 bfloat16. smem = (rows_per_cta + span) * 4.
extern "C" int tsp_spmv_dia_windowed(int val_kind, const void* vals,
                                     const void* offs, int D, int rb,
                                     int off_min, int span, int rows_per_cta,
                                     const void* x, void* y, long long m,
                                     long long n, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows_per_cta < 1 || span < 0) return (int)cudaErrorInvalidValue;
  if (val_kind == 0) {
    return launch_dia<float>(vals, offs, D, rb, off_min, span, rows_per_cta,
                             x, y, m, n, smem, s);
  }
  if (val_kind == 1) {
    return launch_dia<__nv_bfloat16>(vals, offs, D, rb, off_min, span,
                                     rows_per_cta, x, y, m, n, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

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
