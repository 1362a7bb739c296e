// Packed mixed-height SpMV for Hopper (sm_90a): spmv_packed.
//
// Replaces the Pallas kernel tpu_spmv/kernels/packed.py:spmv_packed, both
// of its bodies (_make_packed_kernel with packed-delta window bases,
// _make_packed_grouped_kernel with grouped ones), together with the
// out_row gather that follows it.
//
// The TPU kernel stacks chunk slabs back to back (kc = max(true, 4)
// slots, no 8-slot quantum), so a sub-tile can end two chunks; it
// reduces each sub-tile three ways by the boundaries in bmeta and
// carries the open chunk's sum across sub-tiles and grid steps in a
// VMEM scratch, which relies on Mosaic running the grid in order. CUDA
// blocks run in no order, so here one thread owns a row and sums that
// row's slots [chunk_koff[c], chunk_koff[c+1]) itself (slot_walk.cuh,
// one column): nothing is carried and nothing is gathered afterwards.
// That is the "cut block tiles at chunk ends" option, taken to one
// chunk per thread.
//
// What bounds it: bytes, as for ranked. It streams the packed slots
// once (value 4 or 2 B plus local column 1, 2 or 4 B per slot), which
// is what the layout saves against the 8-slot-quantized ranked layout
// (on a 5-point grid 5 slots per chunk instead of 8), and gathers x
// through L2. A chunk of many slots is walked by one thread, so a
// single long row bounds the whole launch (banded_1m).

#include "slot_walk.cuh"

// val_kind: 0 float32, 1 bfloat16. lcol_kind: 0 uint8, 1 int16, 2 int32.
// G = 0 selects the packed-delta bases; G > 0 the grouped ones.
extern "C" int tsp_spmv_packed(int val_kind, int lcol_kind, const void* vals,
                               const void* lcols, const void* sub_b0,
                               const void* sub_dlo, const void* sub_dhi,
                               const void* grp_b0, int G, unsigned gmap,
                               const void* chunk_koff, const void* x, void* y,
                               long long m, long long n, void* stream) {
  return dispatch_walk<1>(val_kind, lcol_kind, vals, lcols, sub_b0, sub_dlo,
                          sub_dhi, grp_b0, G, gmap, chunk_koff, 0, x, y, m,
                          n, 1, stream);
}
