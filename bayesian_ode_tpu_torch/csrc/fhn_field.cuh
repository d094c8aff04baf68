// The FitzHugh-Nagumo theta-field as the fused adaptive kernels take it
// (dopri5_kernels.cuh):
//
//   V' = c (V - V^3/3 + R),   R' = -(V - a + b R) / c,   theta = (a, b, c)
//
// per chain, as bayesian_ode_tpu/ops/fhn_dopri5.py registers it on the
// public engine.  One chain per thread, theta in registers; the field
// multiplies by inv_c = 1/c, computed once per chain, as the TPU kernel
// does (the host reference of ops/fhn_dopri5.py divides by c).  At three
// weights a chain, the kernels are bound by the FMAs of their serial step
// chain and by the bytes of the dense output and records.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#ifndef FHN_N
#error "FHN_N (trajectory points per chain) must be defined at build time"
#endif

namespace bode {

constexpr int kFN = FHN_N;
constexpr int kFBlock = 64;          // threads per block, one chain each
constexpr float kThird = 1.0f / 3.0f;

struct FHNTheta {
  float a, b, c;
};

struct FHNDopri5 {
  static constexpr int kNS = 2 * FHN_N;
  static constexpr int kThreads = kFBlock;
  static constexpr int kChains = kFBlock;
  struct Args {
    const float *a, *b, *c;
  };
  struct Grads {
    float *a, *b, *c;
  };
  struct Smem {};
  struct AccSmem {};
  using Acc = FHNTheta;

  float a, b, c, inv_c;

  static __device__ int chain() { return blockIdx.x * kFBlock + threadIdx.x; }
  static __device__ bool leader() { return true; }

  static __device__ FHNDopri5 load(const Args& w, Smem&, int C, int ch) {
    FHNDopri5 f{0.f, 0.f, 1.f, 1.f};
    if (ch < C) {
      f.a = w.a[ch];
      f.b = w.b[ch];
      f.c = w.c[ch];
      f.inv_c = 1.0f / f.c;
    }
    return f;
  }
  static __device__ Acc acc_init(AccSmem&) { return FHNTheta{0.f, 0.f, 0.f}; }
  static __device__ void acc_store(const Acc& acc, const Grads& g, int ch) {
    g.a[ch] = acc.a;
    g.b[ch] = acc.b;
    g.c[ch] = acc.c;
  }

  __device__ void rhs(const float* y, float* f) const {
#pragma unroll
    for (int n = 0; n < kFN; ++n) {
      const float x = y[2 * n], r = y[2 * n + 1];
      const float s = x - x * x * x * kThird + r;   // V' = c s
      const float q = x - a + b * r;                // R' = -q / c
      f[2 * n] = c * s;
      f[2 * n + 1] = -q * inv_c;
    }
  }

  // ybar = (df/dy)^T cot, and the theta cotangent accumulated into acc:
  //   d fy/da = 1/c, d fy/db = -R/c, d fy/dc = q/c^2, d fx/dc = s;
  //   d fx/dV = c (1 - V^2), d fx/dR = c, d fy/dV = -1/c, d fy/dR = -b/c.
  __device__ void rhs_vjp(const float* y, const float* cot, float* ybar,
                          Acc& acc) const {
#pragma unroll
    for (int n = 0; n < kFN; ++n) {
      const float x = y[2 * n], r = y[2 * n + 1];
      const float cx = cot[2 * n], cy = cot[2 * n + 1];
      const float s = x - x * x * x * kThird + r;
      const float q = x - a + b * r;
      acc.a = acc.a + cy * inv_c;
      acc.b = acc.b - cy * r * inv_c;
      acc.c = acc.c + cx * s + cy * q * inv_c * inv_c;
      ybar[2 * n] = cx * c * (1.0f - x * x) - cy * inv_c;
      ybar[2 * n + 1] = cx * c - cy * b * inv_c;
    }
  }
};

}  // namespace bode
