// The warp sums shared by the warp-per-chain fields (mlp_field.cuh,
// spiral_field.cuh), and the full-warp mask of the per-point kernels
// (gp_field.cuh, fhn_field.cuh).
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

// The 32 sums over the warp of v[0..31] at once, by the same halving from
// xor 16 down to xor 1: on return lane L holds the sum of v[L].  31
// shuffles; the fields take it where a chain has more than 16 state
// components (N > 8), and warp_sum16 below that.
__device__ __forceinline__ float warp_sum32(const float (&v)[32], int lane) {
  float a[16], b[8], c[4], d[2];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const bool hi = lane & 16;
    a[k] = (hi ? v[k + 16] : v[k])
           + __shfl_xor_sync(kFull, hi ? v[k] : v[k + 16], 16);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const bool hi = lane & 8;
    b[k] = (hi ? a[k + 8] : a[k])
           + __shfl_xor_sync(kFull, hi ? a[k] : a[k + 8], 8);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool hi = lane & 4;
    c[k] = (hi ? b[k + 4] : b[k])
           + __shfl_xor_sync(kFull, hi ? b[k] : b[k + 4], 4);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const bool hi = lane & 2;
    d[k] = (hi ? c[k + 2] : c[k])
           + __shfl_xor_sync(kFull, hi ? c[k] : c[k + 2], 2);
  }
  const bool hi = lane & 1;
  return (hi ? d[1] : d[0]) + __shfl_xor_sync(kFull, hi ? d[0] : d[1], 1);
}

// The width of a field's sums over its NS state components (NS <= 32), and
// the sums by that width: lane i < NS gets the sum of v[i].
template <int NS>
constexpr int kSumWidth = NS <= 16 ? 16 : 32;

// The most warps a block, kMax or a half or quarter of it, whose buffers of
// `bytes` each fit the 48 KB of static shared memory a block may have (1
// if none do: the caller's shape check has raised before the build).
constexpr int warps_fitting(int kMax, unsigned long bytes) {
  return kMax > 1 && kMax * bytes > 48 * 1024 ? warps_fitting(kMax / 2, bytes)
                                               : kMax;
}

__device__ __forceinline__ float warp_sums(const float (&v)[16], int lane) {
  return warp_sum16(v, lane);
}
__device__ __forceinline__ float warp_sums(const float (&v)[32], int lane) {
  return warp_sum32(v, lane);
}

}  // namespace bode
