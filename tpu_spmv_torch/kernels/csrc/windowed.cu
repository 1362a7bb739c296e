// Windowed SpMV and SpMM for Hopper (sm_90a): x is staged, a window per
// block of threads, in shared memory, and every gather reads only that
// copy.
//
// Replaces the Pallas kernels
//   tpu_spmv/kernels/dia.py:spmv_dia_windowed (_make_dia_windowed_kernel),
//   tpu_spmv/kernels/pallas_sell.py:spmv_ranked_windowed
//     (_make_windowed_kernel) and its _reduce_partials epilogue,
//   tpu_spmv/kernels/spmm.py:spmm_ranked_windowed
//     (_make_spmm_windowed_kernel) and its per-column segment-sum.
// On the TPU they are the route for an x too large for VMEM: each grid
// step DMAs its tile's x window from HBM into a double-buffered VMEM
// scratch. Here the window goes to shared memory, once per block, with
// plain cooperative loads and one __syncthreads(); entries outside
// [0, n) are staged as 0, so no load touches memory past x.
// cp.async/TMA double-buffering (staging the next window while this one
// is read) is work for later changes.
//
// dia_windowed_kernel: the window is affine in the row range (no
// metadata), so a block owns `rows_per_cta` rows, fewer than a layout
// tile, and stages x[r0 + off_min, r0 + rows + off_max). Every block
// re-reads the halo (off_max - off_min entries); the wrapper sizes
// rows_per_cta so the halo is a small share (kernels/dia.py). One thread
// per row, diagonals added in ascending offset order, as csrc/dia.cu.
//
// ranked_windowed_kernel: one block per layout tile t (tile_k sublanes,
// tile_k / 8 sub-tiles), whose window is blocks [win_b0[t],
// win_b0[t] + win_span) of x (formats/sell.real_windows: the tile's real
// sub-tiles; a slot outside the window, which only the all-pad tail
// has, reads 0), or those rows of a row-major X (n, B) (one
// contiguous range, so none of the TPU's block-major staging). A chunk's
// sub-tiles can straddle two tiles, so a thread cannot own a row's whole
// sum as in csrc/sell.cu: it writes per-sub-tile partials (S, 128, B),
// and reduce_partials_kernel, a second launch, adds a chunk's partials in
// sub-tile order (walking chunk_ptr). That is the resident ranked
// kernel's order of summation. The window base of sublane r of
// sub-tile s is sub_b0[s] + byte r of sub_dlo/sub_dhi, decoded as uint32
// (grouped layouts carry the same per-sublane deltas), minus win_b0[t].
//
// What bounds them: bytes. The slabs (values and local columns) stream
// once; x is read once per block plus the halo or window overlap; the
// partials add 2 * S * 128 * B * 4 bytes. Shared memory caps the window:
// the wrapper refuses one past device_spec().smem_per_block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 128;
constexpr int kSublanes = 8;
constexpr int kDiaThreads = 512;
constexpr int kWinThreads = 512;
constexpr int kReduceThreads = 256;
constexpr int kColumnTile = 8;

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

template <typename V, typename L, int TB>
__global__ void __launch_bounds__(kWinThreads)
    ranked_windowed_kernel(const V* __restrict__ vals,
                           const L* __restrict__ lcols,
                           const int* __restrict__ sub_b0,
                           const unsigned* __restrict__ sub_dlo,
                           const unsigned* __restrict__ sub_dhi,
                           const int* __restrict__ win_b0, int subs_per_tile,
                           int win_span, const float* __restrict__ X,
                           float* __restrict__ part, long long n, int B) {
  extern __shared__ float win[];
  const long long w0 = win_b0[blockIdx.x];
  const long long win_rows = (long long)win_span * kLanes;
  stage(win, X, w0 * kLanes * B, win_rows * B, n * B);

  const int lane = threadIdx.x & (kLanes - 1);
  const long long s_first = (long long)blockIdx.x * subs_per_tile;
  for (int ls = threadIdx.x / kLanes; ls < subs_per_tile;
       ls += blockDim.x / kLanes) {
    const long long s = s_first + ls;
    const long long b0 = (long long)sub_b0[s] - w0;
    const unsigned lo = sub_dlo[s];
    const unsigned hi = sub_dhi[s];
    const long long k0 = s * kSublanes * kLanes + lane;
    float* out = part + (s * kLanes + lane) * B;
    for (int j0 = 0; j0 < B; j0 += TB) {
      float acc[TB];
#pragma unroll
      for (int j = 0; j < TB; ++j) acc[j] = 0.f;
#pragma unroll
      for (int r = 0; r < kSublanes; ++r) {
        const unsigned word = r < 4 ? lo : hi;
        const long long base = b0 + ((word >> (8 * (r & 3))) & 255u);
        const long long idx = k0 + r * kLanes;
        const long long wr = base * kLanes + (long long)lcols[idx];
        const float v = widen(vals[idx]);
        if ((unsigned long long)wr < (unsigned long long)win_rows) {
          const float* xr = win + wr * B + j0;
#pragma unroll
          for (int j = 0; j < TB; ++j) {
            if (j0 + j < B) acc[j] += v * xr[j];
          }
        }
      }
#pragma unroll
      for (int j = 0; j < TB; ++j) {
        if (j0 + j < B) out[j0 + j] = acc[j];
      }
    }
  }
}

// Y[row, j] = sum over chunk row/128's sub-tiles s, in order, of
// part[s, row % 128, j]: one thread per element of Y.
__global__ void __launch_bounds__(kReduceThreads)
    reduce_partials_kernel(const float* __restrict__ part,
                           const int* __restrict__ chunk_ptr,
                           float* __restrict__ Y, long long m, int B) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m * B) return;
  const long long row = e / B;
  const int j = (int)(e - row * B);
  const long long c = row / kLanes;
  const long long lane = row % kLanes;
  const int s1 = chunk_ptr[c + 1];
  float acc = 0.f;
  for (int s = chunk_ptr[c]; s < s1; ++s) {
    acc += part[((long long)s * kLanes + lane) * B + j];
  }
  Y[e] = acc;
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

template <typename V, typename L, int TB>
int launch_ranked(const void* vals, const void* lcols, const void* sub_b0,
                  const void* sub_dlo, const void* sub_dhi,
                  const void* win_b0, int num_tiles, int subs_per_tile,
                  int win_span, const void* X, void* part, long long n, int B,
                  int smem, cudaStream_t s) {
  static int allowed = 48 * 1024;
  const cudaError_t rc =
      allow_smem(ranked_windowed_kernel<V, L, TB>, smem, &allowed);
  if (rc != cudaSuccess) return (int)rc;
  ranked_windowed_kernel<V, L, TB><<<(unsigned)num_tiles, kWinThreads, smem,
                                     s>>>(
      static_cast<const V*>(vals), static_cast<const L*>(lcols),
      static_cast<const int*>(sub_b0), static_cast<const unsigned*>(sub_dlo),
      static_cast<const unsigned*>(sub_dhi), static_cast<const int*>(win_b0),
      subs_per_tile, win_span, static_cast<const float*>(X),
      static_cast<float*>(part), n, B);
  return (int)cudaGetLastError();
}

template <int TB>
int dispatch_ranked(int val_kind, int lcol_kind, const void* vals,
                    const void* lcols, const void* sub_b0,
                    const void* sub_dlo, const void* sub_dhi,
                    const void* win_b0, int num_tiles, int subs_per_tile,
                    int win_span, const void* X, void* part, long long n, int B,
                    int smem, cudaStream_t s) {
#define TSP_RANKED(V, L)                                                      \
  return launch_ranked<V, L, TB>(vals, lcols, sub_b0, sub_dlo, sub_dhi,       \
                                 win_b0, num_tiles, subs_per_tile, win_span, X, \
                                 part, n, B, smem, s)
  if (val_kind == 0 && lcol_kind == 0) TSP_RANKED(float, uint8_t);
  if (val_kind == 0 && lcol_kind == 1) TSP_RANKED(float, int16_t);
  if (val_kind == 0 && lcol_kind == 2) TSP_RANKED(float, int32_t);
  if (val_kind == 1 && lcol_kind == 0) TSP_RANKED(__nv_bfloat16, uint8_t);
  if (val_kind == 1 && lcol_kind == 1) TSP_RANKED(__nv_bfloat16, int16_t);
  if (val_kind == 1 && lcol_kind == 2) TSP_RANKED(__nv_bfloat16, int32_t);
#undef TSP_RANKED
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

// Y (m, B) = A @ X (n, B), both row-major, through per-tile windows:
// the windowed pass writes part (S, 128, B), then the reduction pass
// writes Y. val_kind as above; lcol_kind: 0 uint8, 1 int16, 2 int32.
// smem = win_span * 128 * B * 4.
extern "C" int tsp_ranked_windowed(int val_kind, int lcol_kind,
                                   const void* vals, const void* lcols,
                                   const void* sub_b0, const void* sub_dlo,
                                   const void* sub_dhi, const void* win_b0,
                                   int num_tiles, int subs_per_tile,
                                   int win_span, const void* chunk_ptr,
                                   const void* X, void* part, void* Y,
                                   long long m, long long n, int B, int smem,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || num_tiles < 1 || subs_per_tile < 1 || win_span < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int rc =
      B == 1 ? dispatch_ranked<1>(val_kind, lcol_kind, vals, lcols, sub_b0,
                                  sub_dlo, sub_dhi, win_b0, num_tiles,
                                  subs_per_tile, win_span, X, part, n, B, smem, s)
             : dispatch_ranked<kColumnTile>(
                   val_kind, lcol_kind, vals, lcols, sub_b0, sub_dlo, sub_dhi,
                   win_b0, num_tiles, subs_per_tile, win_span, X, part, n, B,
                   smem, s);
  if (rc != 0) return rc;
  const long long total = m * B;
  const unsigned blocks =
      (unsigned)((total + kReduceThreads - 1) / kReduceThreads);
  reduce_partials_kernel<<<blocks, kReduceThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<const int*>(chunk_ptr),
      static_cast<float*>(Y), m, B);
  return (int)cudaGetLastError();
}
