// SELL-slab SpMV for Hopper (sm_90a): the ranked and sell kernels.
//
// Replaces the Pallas kernels of tpu_spmv/kernels/pallas_sell.py:
//   spmv_sell (:279, _make_kernel) and spmv_ranked (:541, whose bodies
//   are _make_ranked_kernel :296 and _make_grouped_kernel :397),
//   together with their _reduce_partials epilogue (:103).
//
// Layout (tpu_spmv_torch/formats/sell.py): 128 rows form a chunk, one row
// per lane; a chunk's nonzeros are slot-major (k, 128) slabs, 8 slots
// to a sub-tile; chunk_ptr[c] .. chunk_ptr[c+1] are chunk c's sub-tiles.
// The segment table (formats/sell.segment_fields) cuts each chunk's
// range, in order, into segments of at most SEGMENT_SUBTILES (8) sub-tiles.
//
// Design: the segment walk. One block of 128 threads (4 warps) owns one
// segment, thread l lane l of it. The thread walks the segment's
// sub-tiles and their 8 slots, gathers x at each slot's column, sums the
// 8 slots of a sub-tile into `part` with fused multiply-adds and adds
// `part` into its total, the order of spmv_ranked_windowed
// (csrc/windowed.cu), so the two give the same bits on one layout, split
// chunks included (both fix-ups add the partial rows in segment order).
// A chunk of one segment writes y[row] directly: no partials, no
// epilogue. The segments of a
// split chunk (SPLIT_BIT in seg_chunk) write one partial row each, into
// a scratch of one row per such segment, and a second, small launch adds
// a split chunk's rows into y in segment order: no float atomics, the
// same bits on every call, and no host work between the launches, so a
// captured graph replays the call.
//
// Accumulate mode (the ranked entry's `accumulate`): both launches add
// their row into y (y[row] += acc) instead of storing it, so the passes
// of a column-striped SpMV (kernels/striped.py) sum into one y, in stripe
// order, with no temporary and no elementwise add. Every row of y belongs
// to one chunk, written by one segment or by the fix-up, so each launch
// pair adds to each row once.
//
// Ranked columns: col = 128 * base(s, r) + lcols[8s + r, l], with
//   base(s, r) = sub_b0[s] + byte r of sub_dlo (r < 4) / sub_dhi (r >= 4),
// decoded as uint32 with logical shifts (a signed shift would
// sign-extend any byte >= 128), or, for a grouped layout (G > 0),
//   base(s, r) = grp_b0[s * G + group(r)], group(r) = 4-bit field r of
// gmap. lcols is uint8, int16 or int32 and is widened as its own type.
// Sell columns are absolute int32.
//
// What bounds it, and what the design does about it:
// - The longest walk, first. The first design gave one thread one row
//   and walked a whole chunk in series: banded_1m's chunk of an
//   887-nonzero row has 112 sub-tiles, and 128 threads on one SM walked
//   them, each a chain of dependent loads, long after the other 7,812
//   chunks had finished (556.5 us for ranked against a 55.2 us bound on
//   an H100, PERF.md). A segment caps the walk at 8 sub-tiles, as the
//   TPU kernel's one partial per sub-tile never had the tail.
// - Latency along the walk. Each sub-tile's x gathers wait on its
//   column loads, and a ranked column also on its window bases. The
//   bases of the whole segment are decoded once into shared memory
//   (warp-uniform: every lane walks the same sub-tile), while the first
//   sub-tile's slab loads are already in flight; the slab loads of
//   sub-tile s+1 are issued before the x gathers of sub-tile s, so a
//   thread has the next 16 loads in flight behind the current 8 gathers.
// - Bytes. The slabs are read exactly once, with streaming loads
//   (__ldcs) so they do not evict x, which is gathered through the
//   read-only path (__ldg) and stays in the 50 MB L2 on banded_1m and
//   lap2d_1024 (4 MB). The slab padding (1.72 slots per nonzero on
//   banded_1m) is the layout's and bounds sell above cuSPARSE's time.
// wgmma has no dense product to serve here. x is gathered from L2, not
// staged: the TMA ring of csrc/windowed.cu serves an x past the L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 128;
constexpr int kSublanes = 8;
// Bases staged per segment: 16 sub-tiles x 8 sublanes, one per thread.
// Nothing here checks a segment's length: the containers do, on the
// host, once (formats/sell.MAX_SEGMENT_SUBTILES, _check_tables).
constexpr int kMaxSegSubtiles = kLanes / kSublanes;
constexpr int kSplitBit = 1 << 30;

// Streaming loads of the slabs, widened to float / int.
__device__ __forceinline__ float load_val(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float load_val(const __nv_bfloat16* p) {
  const unsigned short bits =
      __ldcs(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}
__device__ __forceinline__ int load_col(const uint8_t* p) { return __ldcs(p); }
__device__ __forceinline__ int load_col(const int16_t* p) { return __ldcs(p); }
__device__ __forceinline__ int load_col(const int32_t* p) { return __ldcs(p); }

// One sub-tile of one lane: 8 values and 8 (local or absolute) columns.
struct Tile {
  float v[kSublanes];
  int c[kSublanes];
};

template <typename V, typename C>
__device__ __forceinline__ void load_tile(const V* vals, const C* cols,
                                          int s, int lane, Tile& t) {
  const long long k0 = (long long)s * kSublanes * kLanes + lane;
#pragma unroll
  for (int r = 0; r < kSublanes; ++r) {
    t.v[r] = load_val(vals + k0 + r * kLanes);
    t.c[r] = load_col(cols + k0 + r * kLanes);
  }
}

// The ranked layout's decode: window bases per (sub-tile, sublane).
template <typename V, typename L>
struct Ranked {
  static constexpr bool kBases = true;
  const V* vals;
  const L* lcols;
  const int* sub_b0;
  const unsigned* sub_dlo;
  const unsigned* sub_dhi;
  const int* grp_b0;
  int G;
  unsigned gmap;

  __device__ __forceinline__ void load(int s, int lane, Tile& t) const {
    load_tile(vals, lcols, s, lane, t);
  }
  __device__ __forceinline__ int base(int s, int r) const {
    if (G > 0) {
      return __ldg(grp_b0 + (long long)s * G + ((gmap >> (4 * r)) & 15u));
    }
    const unsigned word = __ldg((r < 4 ? sub_dlo : sub_dhi) + s);
    return __ldg(sub_b0 + s) + (int)((word >> (8 * (r & 3))) & 255u);
  }
};

// The sell layout: absolute columns, no bases.
struct Sell {
  static constexpr bool kBases = false;
  const float* vals;
  const int* cols;

  __device__ __forceinline__ void load(int s, int lane, Tile& t) const {
    load_tile(vals, cols, s, lane, t);
  }
  __device__ __forceinline__ int base(int, int) const { return 0; }
};

// One block per segment (see the header). A split chunk's segment
// writes row p of part, p = seg_chunk & ~kSplitBit.
template <typename D>
__global__ void __launch_bounds__(kLanes, 8)
    segment_kernel(D d, const int* __restrict__ seg_ptr,
                   const int* __restrict__ seg_chunk,
                   const float* __restrict__ x, float* __restrict__ y,
                   float* __restrict__ part, long long m, long long n,
                   int accumulate) {
  __shared__ __align__(16) int bases[kMaxSegSubtiles * kSublanes];
  const int seg = blockIdx.x;
  const int lane = threadIdx.x;
  const int s0 = __ldg(seg_ptr + seg);
  const int s1 = __ldg(seg_ptr + seg + 1);
  const int tag = __ldg(seg_chunk + seg);
  Tile cur, nxt;
  if (s0 < s1) d.load(s0, lane, cur);
  if constexpr (D::kBases) {
    if (lane < (s1 - s0) * kSublanes) {
      bases[lane] = d.base(s0 + lane / kSublanes, lane % kSublanes);
    }
    __syncthreads();
  }
  float acc = 0.f;
  for (int s = s0; s < s1; ++s) {
    if (s + 1 < s1) d.load(s + 1, lane, nxt);
    int col[kSublanes];
    if constexpr (D::kBases) {
      const int4* b4 = reinterpret_cast<const int4*>(bases) + 2 * (s - s0);
      const int4 lo = b4[0], hi = b4[1];
      const int b[kSublanes] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int r = 0; r < kSublanes; ++r) col[r] = b[r] * kLanes + cur.c[r];
    } else {
#pragma unroll
      for (int r = 0; r < kSublanes; ++r) col[r] = cur.c[r];
    }
    // An explicit fused multiply-add, as csrc/windowed.cu's walk, so
    // the two kernels give the same bits on one layout.
    float p = 0.f;
#pragma unroll
    for (int r = 0; r < kSublanes; ++r) {
      const float xv = (col[r] >= 0 && col[r] < n) ? __ldg(x + col[r]) : 0.f;
      p = __fmaf_rn(cur.v[r], xv, p);
    }
    acc += p;
    cur = nxt;
  }
  if (tag & kSplitBit) {
    part[(long long)(tag & ~kSplitBit) * kLanes + lane] = acc;
  } else {
    const long long row = (long long)tag * kLanes + lane;
    if (row < m) y[row] = accumulate ? y[row] + acc : acc;
  }
}

// y rows of every split chunk: its partial rows added in segment order.
// One block of 128 threads per split chunk; split_seg is (3, K): the
// chunk, its first partial row and one past its last.
__global__ void __launch_bounds__(kLanes)
    split_fixup_kernel(const int* __restrict__ split_seg, int num_split,
                       const float* __restrict__ part, float* __restrict__ y,
                       long long m, int accumulate) {
  const int lane = threadIdx.x;
  const int c = __ldg(split_seg + blockIdx.x);
  const int p0 = __ldg(split_seg + num_split + blockIdx.x);
  const int p1 = __ldg(split_seg + 2 * num_split + blockIdx.x);
  float acc = 0.f;
  for (int p = p0; p < p1; ++p) acc += part[(long long)p * kLanes + lane];
  const long long row = (long long)c * kLanes + lane;
  if (row < m) y[row] = accumulate ? y[row] + acc : acc;
}

struct Segments {
  const int* seg_ptr;
  const int* seg_chunk;
  int num_segments;
  const int* split_seg;
  int num_split;
};

template <typename D>
int launch_walk(const D& d, const Segments& g, const void* x, void* y,
                void* part, long long m, long long n, int accumulate,
                cudaStream_t s) {
  segment_kernel<D><<<(unsigned)g.num_segments, kLanes, 0, s>>>(
      d, g.seg_ptr, g.seg_chunk, static_cast<const float*>(x),
      static_cast<float*>(y), static_cast<float*>(part), m, n, accumulate);
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess || g.num_split == 0) return (int)rc;
  split_fixup_kernel<<<(unsigned)g.num_split, kLanes, 0, s>>>(
      g.split_seg, g.num_split, static_cast<const float*>(part),
      static_cast<float*>(y), m, accumulate);
  return (int)cudaGetLastError();
}

template <typename V, typename L>
int launch_ranked(const void* vals, const void* lcols, const void* sub_b0,
                  const void* sub_dlo, const void* sub_dhi,
                  const void* grp_b0, int G, unsigned gmap,
                  const Segments& g, const void* x, void* y, void* part,
                  long long m, long long n, int accumulate, cudaStream_t s) {
  const Ranked<V, L> d{static_cast<const V*>(vals),
                       static_cast<const L*>(lcols),
                       static_cast<const int*>(sub_b0),
                       static_cast<const unsigned*>(sub_dlo),
                       static_cast<const unsigned*>(sub_dhi),
                       static_cast<const int*>(grp_b0), G, gmap};
  return launch_walk(d, g, x, y, part, m, n, accumulate, s);
}

}  // namespace

// val_kind: 0 float32, 1 bfloat16. lcol_kind: 0 uint8, 1 int16, 2 int32.
// G = 0 selects the packed-delta bases; G > 0 the grouped ones.
// part: one row of 128 floats per segment of a split chunk. accumulate:
// 0 stores y, 1 adds into it (see the header).
extern "C" int tsp_spmv_ranked(int val_kind, int lcol_kind, const void* vals,
                               const void* lcols, const void* sub_b0,
                               const void* sub_dlo, const void* sub_dhi,
                               const void* grp_b0, int G, unsigned gmap,
                               const void* seg_ptr, const void* seg_chunk,
                               int num_segments, const void* split_seg,
                               int num_split, const void* x, void* y,
                               void* part, long long m, long long n,
                               int accumulate, void* stream) {
  const Segments g{static_cast<const int*>(seg_ptr),
                   static_cast<const int*>(seg_chunk), num_segments,
                   static_cast<const int*>(split_seg), num_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TSP_RANKED(V, L)                                                    \
  return launch_ranked<V, L>(vals, lcols, sub_b0, sub_dlo, sub_dhi, grp_b0, \
                             G, gmap, g, x, y, part, m, n, accumulate, s)
  if (val_kind == 0 && lcol_kind == 0) TSP_RANKED(float, uint8_t);
  if (val_kind == 0 && lcol_kind == 1) TSP_RANKED(float, int16_t);
  if (val_kind == 0 && lcol_kind == 2) TSP_RANKED(float, int32_t);
  if (val_kind == 1 && lcol_kind == 0) TSP_RANKED(__nv_bfloat16, uint8_t);
  if (val_kind == 1 && lcol_kind == 1) TSP_RANKED(__nv_bfloat16, int16_t);
  if (val_kind == 1 && lcol_kind == 2) TSP_RANKED(__nv_bfloat16, int32_t);
#undef TSP_RANKED
  return (int)cudaErrorInvalidValue;
}

extern "C" int tsp_spmv_sell(const void* vals, const void* cols,
                             const void* seg_ptr, const void* seg_chunk,
                             int num_segments, const void* split_seg,
                             int num_split, const void* x, void* y,
                             void* part, long long m, long long n,
                             void* stream) {
  const Segments g{static_cast<const int*>(seg_ptr),
                   static_cast<const int*>(seg_chunk), num_segments,
                   static_cast<const int*>(split_seg), num_split};
  const Sell d{static_cast<const float*>(vals), static_cast<const int*>(cols)};
  return launch_walk(d, g, x, y, part, m, n, 0,
                     static_cast<cudaStream_t>(stream));
}
