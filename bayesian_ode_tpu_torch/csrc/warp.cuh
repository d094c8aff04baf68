// The warp sum shared by the warp-per-chain fields (mlp_field.cuh,
// spiral_field.cuh), and the full-warp mask of the GP field's per-point
// kernels (gp_field.cuh).
#pragma once

#include <cuda_runtime.h>

namespace bode {

constexpr unsigned kFull = 0xffffffffu;

// The 16 sums over the warp of v[0..15] at once, by recursive halving (a
// reduce-scatter): at each of the steps xor 8, 4, 2, 1 a lane keeps the
// half of its partial sums picked by its lane bit and adds the partner's
// copy of that half; a last xor-16 step joins the two half-warps.  On
// return lane L holds the sum of v[L & 15], the same bits on lanes L and
// L ^ 16.  16 shuffles in all, where 16 butterflies take 80; entries the
// caller leaves at zero still cost their shuffle.
__device__ __forceinline__ float warp_sum16(const float (&v)[16], int lane) {
  float a[8], b[4], c[2];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const bool hi = lane & 8;
    a[k] = (hi ? v[k + 8] : v[k])
           + __shfl_xor_sync(kFull, hi ? v[k] : v[k + 8], 8);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool hi = lane & 4;
    b[k] = (hi ? a[k + 4] : a[k])
           + __shfl_xor_sync(kFull, hi ? a[k] : a[k + 4], 4);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const bool hi = lane & 2;
    c[k] = (hi ? b[k + 2] : b[k])
           + __shfl_xor_sync(kFull, hi ? b[k] : b[k + 2], 2);
  }
  const bool hi = lane & 1;
  float d = (hi ? c[1] : c[0]) + __shfl_xor_sync(kFull, hi ? c[0] : c[1], 1);
  return d + __shfl_xor_sync(kFull, d, 16);
}

}  // namespace bode
