// The MLP field 2 -> H -> H -> 2 with ELU activations, as a functor for
// the rk4 templates of rk4_common.cuh and (MLPDopri5 below) the fused
// adaptive kernels of dopri5_kernels.cuh:
//
//   f(x) = W3^T elu(W2^T elu(W1^T x + b1) + b2) + b3
//
// One warp per chain: lane j holds hidden unit j of both hidden layers,
// that is w1[:, j], b1[j], column j of W2 (the 32 weights feeding unit j
// of the second layer), b2[j] and w3[j, :]; b3 is held by every lane.  At
// H=32 a chain has 1,218 weights, 1,024 of them in W2: spread over the
// warp they fit in registers, where one thread per chain would re-read W2
// from L2 at every field evaluation.  h1 reaches the other lanes by
// __shfl_sync and f is a butterfly sum, which leaves the same f on every
// lane, so every lane carries the chain's state and the rk4 templates see
// per-thread state exactly as for the GP field.  Lanes j >= H hold zero
// weights and contribute nothing.
//
// The VJP needs h1bar_i = sum_j W2[i][j] a2bar_j, a sum across the lanes
// that hold row i: the products go through a per-warp 32 x 33 scratch in
// shared memory (padded: conflict-free by rows and by columns) and lane i
// sums its row in order j = 0..H-1, as the TPU kernel does.  Weight
// cotangents accumulate per lane in registers and are written once.
//
// ELU is expf(a) - 1 with derivative a > 0 ? 1 : expf(a), as the TPU
// kernel computes it.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "warp.cuh"

#ifndef MLP_N
#error "MLP_N (trajectory points per chain) must be defined at build time"
#endif
#ifndef MLP_H
#error "MLP_H (hidden width) must be defined at build time"
#endif

namespace bode {

constexpr int kWarpsPerBlock = 4;          // chains per block
constexpr int kMLPBlock = 32 * kWarpsPerBlock;
constexpr int kMN = MLP_N;
constexpr int kMNS = 2 * MLP_N;            // state components per chain
constexpr int kH = MLP_H;
constexpr int kRed = 33;                   // padded row of the VJP scratch
static_assert(kH >= 1 && kH <= 32, "one hidden unit per lane: H <= 32");

__device__ __forceinline__ float elu(float a) {
  return a > 0.f ? a : expf(a) - 1.0f;
}
__device__ __forceinline__ float elu_deriv(float a) {
  return a > 0.f ? 1.0f : expf(a);
}

// This lane's share of one chain's weights (or of their cotangents).
struct MLPUnit {
  float w1x, w1y, b1, b2, w3x, w3y, b3x, b3y;
  float w2c[kH];                           // w2c[i] = W2[i][lane]
};

__device__ __forceinline__ void mlp_zero(MLPUnit& u) {
  u.w1x = u.w1y = u.b1 = u.b2 = u.w3x = u.w3y = u.b3x = u.b3y = 0.f;
#pragma unroll
  for (int i = 0; i < kH; ++i) u.w2c[i] = 0.f;
}

// Chain c's weights in the layer-list layout w1 (C, 2, H), b1 (C, H),
// w2 (C, H, H), b2 (C, H), w3 (C, H, 2), b3 (C, 2); lanes j >= H get 0.
__device__ __forceinline__ void mlp_load(
    MLPUnit& u, int c, int lane, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ w3,
    const float* __restrict__ b3) {
  mlp_zero(u);
  const size_t cc = static_cast<size_t>(c);
  if (lane < kH) {
    u.w1x = w1[cc * 2 * kH + lane];
    u.w1y = w1[cc * 2 * kH + kH + lane];
    u.b1 = b1[cc * kH + lane];
    u.b2 = b2[cc * kH + lane];
    u.w3x = w3[(cc * kH + lane) * 2];
    u.w3y = w3[(cc * kH + lane) * 2 + 1];
#pragma unroll
    for (int i = 0; i < kH; ++i) u.w2c[i] = w2[(cc * kH + i) * kH + lane];
  }
  u.b3x = b3[cc * 2];
  u.b3y = b3[cc * 2 + 1];
}

// Chain c's weight cotangents, in the layout of mlp_load.
__device__ __forceinline__ void mlp_store(
    const MLPUnit& u, int c, int lane, float* __restrict__ w1,
    float* __restrict__ b1, float* __restrict__ w2, float* __restrict__ b2,
    float* __restrict__ w3, float* __restrict__ b3) {
  const size_t cc = static_cast<size_t>(c);
  if (lane < kH) {
    w1[cc * 2 * kH + lane] = u.w1x;
    w1[cc * 2 * kH + kH + lane] = u.w1y;
    b1[cc * kH + lane] = u.b1;
    b2[cc * kH + lane] = u.b2;
    w3[(cc * kH + lane) * 2] = u.w3x;
    w3[(cc * kH + lane) * 2 + 1] = u.w3y;
#pragma unroll
    for (int i = 0; i < kH; ++i) w2[(cc * kH + i) * kH + lane] = u.w2c[i];
  }
  if (lane == 0) {
    b3[cc * 2] = u.b3x;
    b3[cc * 2 + 1] = u.b3y;
  }
}

struct MLPField {
  MLPUnit w;
  float* red;          // this warp's 32 x kRed scratch (VJP only)
  int lane;

  // First layer and second-layer pre-activation of unit `lane` at (x, y).
  __device__ __forceinline__ void hidden(float x, float y, float& a1,
                                         float& h1, float& a2) const {
    a1 = w.w1x * x + w.w1y * y + w.b1;
    h1 = elu(a1);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kH; ++i) s += w.w2c[i] * __shfl_sync(kFull, h1, i);
    a2 = s + w.b2;
  }

  // f at the N points; every lane returns the same f.
  __device__ __forceinline__ void rhs(const float* y, float* f) const {
#pragma unroll
    for (int n = 0; n < kMN; ++n) {
      float a1, h1, a2;
      hidden(y[2 * n], y[2 * n + 1], a1, h1, a2);
      const float h2 = elu(a2);
      f[2 * n] = warp_sum(w.w3x * h2) + w.b3x;
      f[2 * n + 1] = warp_sum(w.w3y * h2) + w.b3y;
    }
  }

  // ybar = (df/dy)^T cot at the N points (the same on every lane), and
  // the weight cotangents of this lane's unit accumulated into g.
  __device__ __forceinline__ void rhs_vjp(const float* y, const float* cot,
                                          float* ybar, MLPUnit& g) const {
#pragma unroll
    for (int n = 0; n < kMN; ++n) {
      const float x = y[2 * n], yy = y[2 * n + 1];
      const float cx = cot[2 * n], cy = cot[2 * n + 1];
      float a1, h1, a2;
      hidden(x, yy, a1, h1, a2);
      const float h2 = elu(a2);
      g.b3x += cx;
      g.b3y += cy;
      g.w3x += h2 * cx;
      g.w3y += h2 * cy;
      const float h2b = w.w3x * cx + w.w3y * cy;
      const float a2b = h2b * elu_deriv(a2);
      g.b2 += a2b;
#pragma unroll
      for (int i = 0; i < kH; ++i) {
        const float h1i = __shfl_sync(kFull, h1, i);
        g.w2c[i] += h1i * a2b;
        red[i * kRed + lane] = w.w2c[i] * a2b;
      }
      __syncwarp();
      float h1b = 0.f;
      if (lane < kH) {
#pragma unroll
        for (int j = 0; j < kH; ++j) h1b += red[lane * kRed + j];
      }
      __syncwarp();
      const float a1b = h1b * elu_deriv(a1);
      g.b1 += a1b;
      g.w1x += x * a1b;
      g.w1y += yy * a1b;
      ybar[2 * n] = warp_sum(w.w1x * a1b);
      ybar[2 * n + 1] = warp_sum(w.w1y * a1b);
    }
  }
};

// The MLP field as the fused adaptive kernels take it (dopri5_kernels.cuh):
// one warp per chain, the weights in the layer-list layout of mlp_load.
// Every lane carries the chain's state and takes the same step decisions
// (warp_sum leaves the same bits on every lane); lane 0 writes the chain's
// outputs.  The backward keeps its per-step arrays (13 x 2N stage floats
// and their cotangents) once per warp in shared memory, since a lane
// already holds 40 weights and 40 weight cotangents in registers.
struct MLPDopri5 {
  static constexpr int kNS = kMNS;
  static constexpr int kThreads = kMLPBlock;
  static constexpr int kChains = kWarpsPerBlock;
  static constexpr bool kStageShared = true;
  struct Args {
    const float *w1, *b1, *w2, *b2, *w3, *b3;
  };
  struct Grads {
    float *w1, *b1, *w2, *b2, *w3, *b3;
  };
  struct Smem {
    float red[kWarpsPerBlock][32 * kRed];   // the VJP's per-warp scratch
  };
  struct AccSmem {};
  using Acc = MLPUnit;

  MLPField f;

  static __device__ int chain() {
    return blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  }
  static __device__ bool leader() { return (threadIdx.x & 31) == 0; }

  static __device__ MLPDopri5 load(const Args& a, Smem& sm, int C, int c) {
    MLPDopri5 m;
    m.f.lane = threadIdx.x & 31;
    m.f.red = sm.red[threadIdx.x >> 5];
    if (c < C)
      mlp_load(m.f.w, c, m.f.lane, a.w1, a.b1, a.w2, a.b2, a.w3, a.b3);
    else
      mlp_zero(m.f.w);
    return m;
  }
  static __device__ Acc acc_init(AccSmem&) {
    MLPUnit u;
    mlp_zero(u);
    return u;
  }
  static __device__ void acc_store(const Acc& acc, const Grads& g, int c) {
    mlp_store(acc, c, threadIdx.x & 31, g.w1, g.b1, g.w2, g.b2, g.w3, g.b3);
  }

  __device__ void rhs(const float* y, float* out) const { f.rhs(y, out); }
  __device__ void rhs_vjp(const float* y, const float* cot, float* ybar,
                          Acc& acc) const {
    f.rhs_vjp(y, cot, ybar, acc);
  }
};

}  // namespace bode
