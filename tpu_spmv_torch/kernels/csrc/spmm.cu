// Multi-vector SpMV (SpMM, Y = A @ X) for Hopper (sm_90a): spmm_ranked
// and spmm_packed.
//
// Replaces the Pallas kernels of tpu_spmv/kernels/spmm.py:
//   spmm_ranked (_make_spmm_kernel) and the per-column segment-sum of
//     its partials;
//   spmm_packed (_make_spmm_packed_kernel, packed-delta and grouped
//     bases) and its out_row gather.
//
// The TPU kernels stage X block-major and column-minor so one (2B, 128)
// VMEM load serves every column, write (S*B, 128) or (2*S*B, 128)
// partials, and (packed) carry a (B, 128) sum across grid steps. None
// of that carries over: X stays row-major (n, B), so the B values a
// gathered column needs are contiguous, and one thread owns a row and a
// tile of up to 8 columns, keeping 8 sums in registers
// (slot_walk.cuh); grid.y walks the column tiles, so any B >= 1 works.
// spmm_ranked walks a chunk's sub-tiles through chunk_ptr and reads only
// the packed-delta bases, as the TPU kernel does: they hold each
// sublane's window base in grouped layouts too, because the deltas are
// taken after the grouping (formats/sell.py).
//
// What bounds it: bytes. The slab bytes are read once per column tile
// (once for B <= 8) and amortize over its columns; each slot adds a
// gather of up to 32 contiguous bytes of X, which stays in L2 when the
// matrix is banded. A long chunk is walked by one thread, as in the
// single-vector kernels.

#include "slot_walk.cuh"

namespace {
constexpr int kColumnTile = 8;
}  // namespace

extern "C" int tsp_spmm_ranked(int val_kind, int lcol_kind, const void* vals,
                               const void* lcols, const void* sub_b0,
                               const void* sub_dlo, const void* sub_dhi,
                               const void* chunk_ptr, const void* X, void* Y,
                               long long m, long long n, int B,
                               void* stream) {
  return dispatch_walk<kColumnTile>(val_kind, lcol_kind, vals, lcols, sub_b0,
                                    sub_dlo, sub_dhi, nullptr, 0, 0u,
                                    chunk_ptr, 3, X, Y, m, n, B, stream);
}

extern "C" int tsp_spmm_packed(int val_kind, int lcol_kind, const void* vals,
                               const void* lcols, const void* sub_b0,
                               const void* sub_dlo, const void* sub_dhi,
                               const void* grp_b0, int G, unsigned gmap,
                               const void* chunk_koff, const void* X, void* Y,
                               long long m, long long n, int B,
                               void* stream) {
  return dispatch_walk<kColumnTile>(val_kind, lcol_kind, vals, lcols, sub_b0,
                                    sub_dlo, sub_dhi, grp_b0, G, gmap,
                                    chunk_koff, 0, X, Y, m, n, B, stream);
}
