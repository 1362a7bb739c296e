// Multi-vector SpMV (SpMM, Y = A @ X) for Hopper (sm_90a): spmm_ranked.
// (spmm_packed is csrc/packed.cu's segment walk, compiled per width.)
//
// Replaces the Pallas kernel tpu_spmv/kernels/spmm.py:spmm_ranked
// (_make_spmm_kernel) and the per-column segment-sum of its partials.
//
// The TPU kernel stages X block-major and column-minor so one (2B, 128)
// VMEM load serves every column and writes (S*B, 128) partials. None of
// that carries over: X stays row-major (n, B), so the B values a
// gathered column needs are contiguous, and one thread owns a row and a
// tile of up to 8 columns, keeping 8 sums in registers
// (slot_walk.cuh); grid.y walks the column tiles, so any B >= 1 works.
// It walks a chunk's sub-tiles through chunk_ptr and reads only the
// packed-delta bases, as the TPU kernel does: they hold each sublane's
// window base in grouped layouts too, because the deltas are taken
// after the grouping (formats/sell.py).
//
// What bounds it: bytes. The slab bytes are read once per column tile
// (once for B <= 8) and amortize over its columns; each slot adds a
// gather of up to 32 contiguous bytes of X, which stays in L2 when the
// matrix is banded. A long chunk is walked by one thread, so a single
// long row bounds the whole launch (banded_1m).

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
