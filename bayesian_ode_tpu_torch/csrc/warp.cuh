// Warp sums shared by the warp-per-chain fields (mlp_field.cuh,
// spiral_field.cuh).
#pragma once

#include <cuda_runtime.h>

namespace bode {

constexpr unsigned kFull = 0xffffffffu;

// Sum over the warp, the same value on every lane (xor butterfly: each
// pairwise sum is formed once per pair, in both lanes, so the lanes agree
// bit for bit).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

}  // namespace bode
