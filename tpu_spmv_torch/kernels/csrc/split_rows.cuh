// The fix-up launch of the column-tiled segment walks (csrc/windowed.cu,
// csrc/packed.cu): Y rows of every split chunk, its segments' partial
// rows added in segment order, column by column, so a call gives the
// same bits every time (no float atomics). One block of 128 threads per
// split chunk; split_seg is (3, K): the chunk, its first partial row and
// one past its last; part is (P, 128, B), Y is (m, B).

#pragma once

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(128)
    split_rows_kernel(const int* __restrict__ split_seg, int num_split,
                      const float* __restrict__ part, float* __restrict__ Y,
                      long long m, int B) {
  const int lane = threadIdx.x;
  const int c = __ldg(split_seg + blockIdx.x);
  const int p0 = __ldg(split_seg + num_split + blockIdx.x);
  const int p1 = __ldg(split_seg + 2 * num_split + blockIdx.x);
  const long long row = (long long)c * 128 + lane;
  if (row >= m) return;
  for (int j = 0; j < B; ++j) {
    float acc = 0.f;
    for (int p = p0; p < p1; ++p) {
      acc += part[((long long)p * 128 + lane) * B + j];
    }
    Y[row * B + j] = acc;
  }
}

}  // namespace
