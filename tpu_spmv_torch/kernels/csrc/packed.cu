// Packed mixed-height SpMV and SpMM for Hopper (sm_90a): spmv_packed and
// spmm_packed, one walk compiled per column count, which also walks the
// rank-windowed SELL layout for spmm_ranked.
//
// Replaces the Pallas kernels tpu_spmv/kernels/packed.py:spmv_packed
// (both bodies: _make_packed_kernel with packed-delta window bases,
// _make_packed_grouped_kernel with grouped ones) and
// tpu_spmv/kernels/spmm.py:spmm_packed (_make_spmm_packed_kernel), each
// with the out_row gather that follows it, and
// tpu_spmv/kernels/spmm.py:spmm_ranked (_make_spmm_kernel) with its
// per-column segment-sum of partials.
//
// Layout (tpu_spmv_torch/formats/packed.py): 128 rows form a chunk, one
// row per lane; chunk c's slots are [chunk_koff[c], chunk_koff[c+1]),
// stacked back to back (max(true, 4) slots a chunk, no 8-slot quantum),
// so a sub-tile of 8 slots can hold the tail of one chunk, whole chunks
// and the head of the next. Slot k lies in sub-tile s = k >> 3 at
// sublane r = k & 7, and its column at lane l is
//   col = 128 * base(s, r) + lcols[k, l],
//   base(s, r) = sub_b0[s] + byte r of sub_dlo (r < 4) / sub_dhi (r >= 4)
// decoded as uint32 with logical shifts (a signed shift would
// sign-extend a byte >= 128), or, when G > 0,
//   base(s, r) = grp_b0[s * G + group(r)], group(r) = 4-bit field r of
// gmap. A column outside [0, n) adds 0.
//
// The TPU kernel reduces each sub-tile three ways by the chunk ends in
// bmeta and carries the open chunk's sum across sub-tiles and grid
// steps, which relies on Mosaic running the grid in order. CUDA blocks
// run in no order, so the port walks two tables instead
// (formats/packed.walk_fields): the segment table cuts each chunk's
// slots at sub-tile boundaries inside the chunk into segments that touch
// at most 8 sub-tiles, and the run table groups consecutive segments
// into runs of at most 8 sub-tiles and 8 segments. A RankedSlabs layout
// (formats/sell.py) is the special case whose chunks are whole sub-tiles:
// its segment table counts sub-tiles (seg_shift 3 turns it into slots),
// it carries a run table over the same cut (formats/packed.run_fields of
// seg_ptr * 8), and its packed deltas hold a grouped layout's bases too,
// so spmm_ranked walks it with G = 0. That replaced the first port's
// thread-a-row walk, whose one thread walking banded_1m's 887-nonzero
// row set the pace of the launch (590 us at B = 8, PERF.md). One block of 128
// threads walks one run, thread l row l of each segment's chunk: it
// streams the run's sub-tiles and, at each segment's end, writes the
// segment's sum and starts the next (warp-uniform: every lane is at the
// same slot). A chunk of one segment writes its rows of Y directly; the
// segments of a split chunk (SPLIT_BIT in seg_chunk) each write one
// partial row into a scratch, and a second, small launch adds a split
// chunk's rows into Y in segment order: no float atomics, the same bits
// on every call, and no host work between the launches, so a captured
// graph replays the call.
//
// What bounds it, and what the design does about it (times: H100,
// bench/packed_times.py, PERF.md):
// - The longest walk. The first port gave one thread one row and walked
//   the chunk's whole slot range in series: banded_1m's chunk of an
//   887-nonzero row set the pace of the launch (190 us against a 48 us
//   bound). A segment caps the walk at 8 sub-tiles.
// - Latency per block. A block's chain (its table entries, then the slab
//   loads and window bases, a barrier, then the gathers) costs about the
//   same for one chunk of lap2d_1024 (5 slots) as for a run of 8. Runs
//   cut lap2d_1024's 8192 blocks to 1024 and keep the next sub-tile's
//   slab loads in flight across chunk ends (one block a segment: 20.1 us,
//   runs: 15.2 us; banded_1m's chunks of 2 to 4 sub-tiles pair up, and
//   lose 7% to one block a segment there).
// - Shared sub-tiles. Only a run's first and last sub-tile can hold
//   another run's slots. Every sub-tile runs the same unrolled 8 slots,
//   each load predicated on the run's slot range, so the loads of a
//   shared sub-tile issue together as those of a whole one do (its slots
//   in a plain loop, as the first port ran them: 11-34% slower). A slot
//   row (128 lanes) belongs to one chunk, so a predicated slot moves no
//   byte another block needs.
// - Latency along the walk. The run's window bases, segment ends and
//   outputs are staged once in shared memory while the first sub-tile's
//   slab loads are in flight; the slab loads of sub-tile s+1 are issued
//   before the X gathers of sub-tile s (without: 2-14% slower), and every
//   gather of a sub-tile before any of its stores.
// - Bytes. The slabs are read once, with streaming loads (__ldcs) so
//   they do not evict X, gathered through the read-only path (__ldg). A
//   thread reads its gathered row of X, and writes its row of Y, with
//   the widest aligned vector the width allows (float4 when B % 4 == 0,
//   float2 when B % 2 == 0, else scalars: B = 8 is 1.7-2x slower with
//   scalars); the width NB of a launch (1 to 8 columns, one launch per
//   group of 8) is compiled in, so B = 5 does 5 columns of work a slot.
// Sums use explicit fused multiply-adds, slot by slot in slot order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "split_rows.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kSublanes = 8;
// Staged per run, one per thread: the window bases of 16 sub-tiles x 8
// sublanes, and the ends and outputs of up to 127 segments. Nothing here
// checks a run: the container does, on the host, once
// (formats/packed.check_runs).
constexpr int kMaxRunSubtiles = kLanes / kSublanes;
constexpr int kSplitBit = 1 << 30;
constexpr int kMaxWidth = 8;

__device__ __forceinline__ float load_val(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float load_val(const __nv_bfloat16* p) {
  const unsigned short bits =
      __ldcs(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}
__device__ __forceinline__ int load_col(const uint8_t* p) { return __ldcs(p); }
__device__ __forceinline__ int load_col(const int16_t* p) { return __ldcs(p); }
__device__ __forceinline__ int load_col(const int32_t* p) { return __ldcs(p); }

template <typename V, typename L>
struct PackedArgs {
  const V* vals;
  const L* lcols;
  const int* sub_b0;
  const unsigned* sub_dlo;
  const unsigned* sub_dhi;
  const int* grp_b0;
  int G;
  unsigned gmap;
  const int* seg_ptr;
  int seg_shift;  // seg_ptr << seg_shift counts slots
  const int* seg_chunk;
  const int* run_ptr;
  int num_runs;
  const float* X;
  float* Y;
  float* part;
  long long m, n;
  int B;
};

// One sub-tile of one lane: 8 values and 8 local columns; a slot
// outside the run holds value 0.
struct Tile {
  float v[kSublanes];
  int c[kSublanes];
};

// Slot r of sub-tile s lies in the run's slots [k0, k1).
__device__ __forceinline__ bool inside(int r, int s, int k0, int k1) {
  return r >= k0 - s * kSublanes && r < k1 - s * kSublanes;
}

template <typename V, typename L>
__device__ __forceinline__ void load_tile(const PackedArgs<V, L>& a, int s,
                                          int k0, int k1, int lane,
                                          Tile& t) {
  const long long e0 = (long long)s * kSublanes * kLanes + lane;
#pragma unroll
  for (int r = 0; r < kSublanes; ++r) {
    const bool in = inside(r, s, k0, k1);
    t.v[r] = in ? load_val(a.vals + e0 + r * kLanes) : 0.f;
    t.c[r] = in ? load_col(a.lcols + e0 + r * kLanes) : 0;
  }
}

template <typename V, typename L>
__device__ __forceinline__ int window_base(const PackedArgs<V, L>& a, int s,
                                           int r) {
  if (a.G > 0) {
    return __ldg(a.grp_b0 + (long long)s * a.G + ((a.gmap >> (4 * r)) & 15u));
  }
  const unsigned word = __ldg((r < 4 ? a.sub_dlo : a.sub_dhi) + s);
  return __ldg(a.sub_b0 + s) + (int)((word >> (8 * (r & 3))) & 255u);
}

// NB floats of a row of X at p (VEC-float aligned), or zeros.
template <int NB, int VEC>
__device__ __forceinline__ void load_row(const float* p, bool ok,
                                         float (&v)[NB]) {
  if constexpr (VEC == 4) {
#pragma unroll
    for (int q = 0; q < NB / 4; ++q) {
      const float4 t = ok ? __ldg(reinterpret_cast<const float4*>(p) + q)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else if constexpr (VEC == 2) {
#pragma unroll
    for (int q = 0; q < NB / 2; ++q) {
      const float2 t = ok ? __ldg(reinterpret_cast<const float2*>(p) + q)
                          : make_float2(0.f, 0.f);
      v[2 * q] = t.x;
      v[2 * q + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < NB; ++j) v[j] = ok ? __ldg(p + j) : 0.f;
  }
}

template <int NB, int VEC>
__device__ __forceinline__ void store_row(float* p, const float (&v)[NB]) {
  if constexpr (VEC == 4) {
#pragma unroll
    for (int q = 0; q < NB / 4; ++q) {
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
  } else if constexpr (VEC == 2) {
#pragma unroll
    for (int q = 0; q < NB / 2; ++q) {
      reinterpret_cast<float2*>(p)[q] = make_float2(v[2 * q], v[2 * q + 1]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < NB; ++j) p[j] = v[j];
  }
}

// One block per run of segments (see the header), columns [j0, j0 + NB)
// of X and Y (row stride B). The run's segments end at ends[0..ne) (slot
// offsets) and write to tags[0..ne): a chunk's rows of Y, or, with
// kSplitBit, row p = tag & ~kSplitBit of part, which is (P, 128, B).
template <typename V, typename L, int NB, int VEC>
__global__ void __launch_bounds__(kLanes, NB <= 2 ? 8 : 4)
    packed_walk_kernel(const PackedArgs<V, L> a, int j0) {
  __shared__ __align__(16) int bases[kMaxRunSubtiles * kSublanes];
  __shared__ int ends[kLanes];
  __shared__ int tags[kLanes];
  const int lane = threadIdx.x;
  const int e0 = __ldg(a.run_ptr + blockIdx.x);
  const int ne = __ldg(a.run_ptr + blockIdx.x + 1) - e0;
  const int k0 = __ldg(a.run_ptr + a.num_runs + 1 + blockIdx.x);
  const int k1 = __ldg(a.run_ptr + a.num_runs + 2 + blockIdx.x);
  const int s0 = k0 / kSublanes;
  const int s1 = (k1 + kSublanes - 1) / kSublanes;
  Tile cur, nxt;
  load_tile(a, s0, k0, k1, lane, cur);
  if (lane < (s1 - s0) * kSublanes) {
    bases[lane] = window_base(a, s0 + lane / kSublanes, lane % kSublanes);
  }
  if (lane < ne) {
    ends[lane] = __ldg(a.seg_ptr + e0 + lane + 1) << a.seg_shift;
    tags[lane] = __ldg(a.seg_chunk + e0 + lane);
  }
  __syncthreads();
  float acc[NB];
  const auto flush = [&](int tag) {
    float* out = nullptr;
    if (tag & kSplitBit) {
      out = a.part + ((long long)(tag & ~kSplitBit) * kLanes + lane) * a.B;
    } else if ((long long)tag * kLanes + lane < a.m) {
      out = a.Y + ((long long)tag * kLanes + lane) * a.B;
    }
    if (out != nullptr) store_row<NB, VEC>(out + j0, acc);
#pragma unroll
    for (int j = 0; j < NB; ++j) acc[j] = 0.f;
  };
#pragma unroll
  for (int j = 0; j < NB; ++j) acc[j] = 0.f;
  int e = 0;
  int kend = ends[0];
  for (int s = s0; s < s1; ++s) {
    if (s + 1 < s1) load_tile(a, s + 1, k0, k1, lane, nxt);
    const int4* b4 = reinterpret_cast<const int4*>(bases) + 2 * (s - s0);
    const int4 lo = b4[0], hi = b4[1];
    const int b[kSublanes] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    // Every gather of the sub-tile before any store of a segment's row.
    float xv[kSublanes][NB];
#pragma unroll
    for (int r = 0; r < kSublanes; ++r) {
      const long long col = (long long)b[r] * kLanes + cur.c[r];
      const bool ok = inside(r, s, k0, k1) && col >= 0 && col < a.n;
      load_row<NB, VEC>(a.X + col * a.B + j0, ok, xv[r]);
    }
#pragma unroll
    for (int r = 0; r < kSublanes; ++r) {
      if (s * kSublanes + r == kend && e + 1 < ne) {  // warp-uniform
        flush(tags[e]);
        kend = ends[++e];
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        acc[j] = __fmaf_rn(cur.v[r], xv[r][j], acc[j]);
      }
    }
    cur = nxt;
  }
  flush(tags[e]);
}

template <typename V, typename L, int NB, int VEC>
int launch_group(const PackedArgs<V, L>& a, int num_runs, int j0,
                 cudaStream_t s) {
  packed_walk_kernel<V, L, NB, VEC><<<(unsigned)num_runs, kLanes, 0, s>>>(
      a, j0);
  return (int)cudaGetLastError();
}

// The instance of width nb (1 to 8) and vector vec (1, 2 or 4, dividing
// nb) for columns [j0, j0 + nb).
template <typename V, typename L>
int run_group(const PackedArgs<V, L>& a, int num_runs, int j0, int nb,
              int vec, cudaStream_t s) {
#define TSP_WIDTH(NB, VEC)                                  \
  if (nb == NB && vec == VEC) {                             \
    return launch_group<V, L, NB, VEC>(a, num_runs, j0, s); \
  }
  TSP_WIDTH(1, 1) TSP_WIDTH(2, 1) TSP_WIDTH(2, 2) TSP_WIDTH(3, 1)
  TSP_WIDTH(4, 1) TSP_WIDTH(4, 2) TSP_WIDTH(4, 4) TSP_WIDTH(5, 1)
  TSP_WIDTH(6, 1) TSP_WIDTH(6, 2) TSP_WIDTH(7, 1) TSP_WIDTH(8, 1)
  TSP_WIDTH(8, 2) TSP_WIDTH(8, 4)
#undef TSP_WIDTH
  return (int)cudaErrorInvalidValue;
}

template <typename V, typename L>
int run_packed(const PackedArgs<V, L>& a, int num_runs,
               const int* split_seg, int num_split, cudaStream_t s) {
  // The widest vector that every row of X, Y and part starts on.
  const auto aligned = [&](int bytes) {
    const uintptr_t mask = (uintptr_t)bytes - 1;
    return (a.B * 4) % bytes == 0 && ((uintptr_t)a.X & mask) == 0 &&
           ((uintptr_t)a.Y & mask) == 0 && ((uintptr_t)a.part & mask) == 0;
  };
  const int vec = aligned(16) ? 4 : aligned(8) ? 2 : 1;
  for (int j0 = 0; j0 < a.B; j0 += kMaxWidth) {
    const int nb = a.B - j0 < kMaxWidth ? a.B - j0 : kMaxWidth;
    const int rc = run_group(a, num_runs, j0, nb, vec, s);
    if (rc != 0) return rc;
  }
  if (num_split == 0) return 0;
  split_rows_kernel<<<(unsigned)num_split, kLanes, 0, s>>>(
      split_seg, num_split, a.part, a.Y, a.m, a.B);
  return (int)cudaGetLastError();
}

}  // namespace

// Y (m, B) = A @ X (n, B), both row-major float32 (B = 1 for
// spmv_packed): the walk of the run table, one launch per group of at
// most 8 columns, then, when a chunk is split (num_split > 0), one launch that
// adds the split chunks' partial rows (part: one row of 128 x B floats
// per segment of a split chunk) into Y. val_kind: 0 float32, 1 bfloat16;
// lcol_kind: 0 uint8, 1 int16, 2 int32. G = 0 selects the packed-delta
// bases; G > 0 the grouped ones. seg_shift: 0 when seg_ptr counts slots
// (PackedRanked), 3 when it counts sub-tiles (RankedSlabs); run_ptr's
// second row counts slots either way.
extern "C" int tsp_packed(int val_kind, int lcol_kind, const void* vals,
                          const void* lcols, const void* sub_b0,
                          const void* sub_dlo, const void* sub_dhi,
                          const void* grp_b0, int G, unsigned gmap,
                          const void* seg_ptr, int seg_shift,
                          const void* seg_chunk, const void* run_ptr,
                          int num_runs, const void* split_seg, int num_split,
                          const void* X, void* Y, void* part, long long m,
                          long long n, int B, void* stream) {
  if (B < 1 || G < 0 || G > 8 || num_runs < 1 || num_split < 0 ||
      (seg_shift != 0 && seg_shift != 3)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TSP_PACKED(V, L)                                                      \
  {                                                                           \
    const PackedArgs<V, L> a{                                                 \
        static_cast<const V*>(vals), static_cast<const L*>(lcols),           \
        static_cast<const int*>(sub_b0),                                      \
        static_cast<const unsigned*>(sub_dlo),                                \
        static_cast<const unsigned*>(sub_dhi),                                \
        static_cast<const int*>(grp_b0), G, gmap,                             \
        static_cast<const int*>(seg_ptr), seg_shift,                         \
        static_cast<const int*>(seg_chunk),                                   \
        static_cast<const int*>(run_ptr), num_runs,                           \
        static_cast<const float*>(X), static_cast<float*>(Y),                 \
        static_cast<float*>(part), m, n, B};                                  \
    return run_packed(a, num_runs, static_cast<const int*>(split_seg),       \
                      num_split, s);                                          \
  }
  if (val_kind == 0 && lcol_kind == 0) TSP_PACKED(float, uint8_t);
  if (val_kind == 0 && lcol_kind == 1) TSP_PACKED(float, int16_t);
  if (val_kind == 0 && lcol_kind == 2) TSP_PACKED(float, int32_t);
  if (val_kind == 1 && lcol_kind == 0) TSP_PACKED(__nv_bfloat16, uint8_t);
  if (val_kind == 1 && lcol_kind == 1) TSP_PACKED(__nv_bfloat16, int16_t);
  if (val_kind == 1 && lcol_kind == 2) TSP_PACKED(__nv_bfloat16, int32_t);
#undef TSP_PACKED
  return (int)cudaErrorInvalidValue;
}
