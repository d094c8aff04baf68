// The spiral y^3-net field as the fused adaptive kernels take it
// (dopri5_kernels.cuh):
//
//   f(y) = W2^T tanh(W1^T y^3 + b1) + b2,   y in R^2, H hidden units
//
// the reference spiral demo's learned dynamics with per-chain weights
// (bayesian_ode_tpu/ops/spiral_dopri5.py, whose VJP this copies).
//
// Design: one warp per chain, ceil(H/32) hidden units per lane (lane l
// holds units l, l + 32, ...; units past H hold zero weights and add
// nothing), the per-point sums by butterfly.  At H=50 a lane keeps 12
// weights and 12 cotangents in registers.  The alternative, one thread per
// chain with its 252 weights staged in shared memory, would leave 10,112
// chains as about 77 threads per SM: 2-3 warps to hide the latency of 50
// serial tanhf per point.  A warp per chain puts about 77 warps on each SM
// and 2 tanhf per lane per point; the price is 14 idle lanes in the second
// unit slot and two butterfly sums per point.  Every lane carries the
// chain's state and takes the same step decisions; lane 0 writes the
// outputs.  tanhf is the full-precision one (no fast math).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "warp.cuh"

#ifndef SPIRAL_N
#error "SPIRAL_N (trajectory points per chain) must be defined at build time"
#endif
#ifndef SPIRAL_H
#error "SPIRAL_H (hidden width) must be defined at build time"
#endif

namespace bode {

constexpr int kSN = SPIRAL_N;
constexpr int kSH = SPIRAL_H;
constexpr int kSU = (SPIRAL_H + 31) / 32;     // hidden units per lane
constexpr int kSWarps = 4;                    // chains per block

// This lane's hidden units of one chain's weights (or their cotangents).
struct SpiralUnits {
  float w1x[kSU], w1y[kSU], b1[kSU], w2x[kSU], w2y[kSU];
  float b2x, b2y;
};

__device__ __forceinline__ void spiral_zero(SpiralUnits& u) {
#pragma unroll
  for (int k = 0; k < kSU; ++k)
    u.w1x[k] = u.w1y[k] = u.b1[k] = u.w2x[k] = u.w2y[k] = 0.f;
  u.b2x = u.b2y = 0.f;
}

struct SpiralField {
  SpiralUnits w;

  // f at the N points; every lane returns the same f.
  __device__ __forceinline__ void rhs(const float* y, float* f) const {
#pragma unroll
    for (int n = 0; n < kSN; ++n) {
      const float x = y[2 * n], yy = y[2 * n + 1];
      const float u = x * x * x, v = yy * yy * yy;
      float px = 0.f, py = 0.f;
#pragma unroll
      for (int k = 0; k < kSU; ++k) {
        const float h = tanhf(w.w1x[k] * u + w.w1y[k] * v + w.b1[k]);
        px += w.w2x[k] * h;
        py += w.w2y[k] * h;
      }
      f[2 * n] = warp_sum(px) + w.b2x;
      f[2 * n + 1] = warp_sum(py) + w.b2y;
    }
  }

  // ybar = (df/dy)^T cot at the N points (the same on every lane), and the
  // weight cotangents of this lane's units accumulated into g (b2's by
  // every lane alike; lane 0 stores it).
  __device__ __forceinline__ void rhs_vjp(const float* y, const float* cot,
                                          float* ybar, SpiralUnits& g) const {
#pragma unroll
    for (int n = 0; n < kSN; ++n) {
      const float x = y[2 * n], yy = y[2 * n + 1];
      const float cx = cot[2 * n], cy = cot[2 * n + 1];
      const float u = x * x * x, v = yy * yy * yy;
      float sx = 0.f, sy = 0.f;
#pragma unroll
      for (int k = 0; k < kSU; ++k) {
        const float h = tanhf(w.w1x[k] * u + w.w1y[k] * v + w.b1[k]);
        g.w2x[k] += h * cx;
        g.w2y[k] += h * cy;
        const float hb = w.w2x[k] * cx + w.w2y[k] * cy;
        const float a1b = hb * (1.0f - h * h);    // tanh' = 1 - tanh^2
        g.b1[k] += a1b;
        g.w1x[k] += u * a1b;
        g.w1y[k] += v * a1b;
        sx += w.w1x[k] * a1b;
        sy += w.w1y[k] * a1b;
      }
      g.b2x += cx;
      g.b2y += cy;
      // d(y^3)/dy = 3 y^2
      ybar[2 * n] = 3.0f * x * x * warp_sum(sx);
      ybar[2 * n + 1] = 3.0f * yy * yy * warp_sum(sy);
    }
  }
};

// The adapter of dopri5_kernels.cuh.  Weights w1 (C, 2, H), b1 (C, H),
// w2 (C, H, 2), b2 (C, 2), the layout of models/spiral.py's parameters.
struct SpiralDopri5 {
  static constexpr int kNS = 2 * SPIRAL_N;
  static constexpr int kThreads = 32 * kSWarps;
  static constexpr int kChains = kSWarps;
  static constexpr bool kStageShared = true;
  struct Args {
    const float *w1, *b1, *w2, *b2;
  };
  struct Grads {
    float *w1, *b1, *w2, *b2;
  };
  struct Smem {};
  struct AccSmem {};
  using Acc = SpiralUnits;

  SpiralField f;

  static __device__ int chain() {
    return blockIdx.x * kSWarps + (threadIdx.x >> 5);
  }
  static __device__ bool leader() { return (threadIdx.x & 31) == 0; }

  static __device__ SpiralDopri5 load(const Args& a, Smem&, int C, int c) {
    SpiralDopri5 s;
    spiral_zero(s.f.w);
    if (c >= C) return s;
    const size_t cc = static_cast<size_t>(c);
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 0; k < kSU; ++k) {
      const int j = lane + 32 * k;
      if (j < kSH) {
        s.f.w.w1x[k] = a.w1[cc * 2 * kSH + j];
        s.f.w.w1y[k] = a.w1[cc * 2 * kSH + kSH + j];
        s.f.w.b1[k] = a.b1[cc * kSH + j];
        s.f.w.w2x[k] = a.w2[(cc * kSH + j) * 2];
        s.f.w.w2y[k] = a.w2[(cc * kSH + j) * 2 + 1];
      }
    }
    s.f.w.b2x = a.b2[cc * 2];
    s.f.w.b2y = a.b2[cc * 2 + 1];
    return s;
  }
  static __device__ Acc acc_init(AccSmem&) {
    SpiralUnits u;
    spiral_zero(u);
    return u;
  }
  static __device__ void acc_store(const Acc& acc, const Grads& g, int c) {
    const size_t cc = static_cast<size_t>(c);
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 0; k < kSU; ++k) {
      const int j = lane + 32 * k;
      if (j < kSH) {
        g.w1[cc * 2 * kSH + j] = acc.w1x[k];
        g.w1[cc * 2 * kSH + kSH + j] = acc.w1y[k];
        g.b1[cc * kSH + j] = acc.b1[k];
        g.w2[(cc * kSH + j) * 2] = acc.w2x[k];
        g.w2[(cc * kSH + j) * 2 + 1] = acc.w2y[k];
      }
    }
    if (lane == 0) {
      g.b2[cc * 2] = acc.b2x;
      g.b2[cc * 2 + 1] = acc.b2y;
    }
  }

  __device__ void rhs(const float* y, float* out) const { f.rhs(y, out); }
  __device__ void rhs_vjp(const float* y, const float* cot, float* ybar,
                          Acc& acc) const {
    f.rhs_vjp(y, cot, ybar, acc);
  }
};

}  // namespace bode
