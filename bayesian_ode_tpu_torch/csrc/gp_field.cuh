// The GP kernel-regression field as a functor, shared by the fused adaptive
// kernels (GPDopri5 below, dopri5_kernels.cuh) and the fused rk4 kernels
// (gp_rk4.cu):
//
//   f(x_n) = sum_m sf^2 exp(-|x_n - z_m|^2 / (2 ell^2)) A_m
//
// One chain per thread.  State layout per chain: NS = 2 * GP_N floats,
// y[2n + d] (the JAX (N, 2) layout).  Full float32 throughout: built
// without --use_fast_math and with expf.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#ifndef GP_N
#error "GP_N (trajectory points per chain) must be defined at build time"
#endif
#ifndef GP_M
#error "GP_M (inducing points) must be defined at build time"
#endif

namespace bode {

constexpr int kBlock = 64;       // threads per block, one chain per thread
constexpr int kN = GP_N;
constexpr int kM = GP_M;
constexpr int kNS = 2 * GP_N;    // state components per chain

// A is staged per block in shared memory as sA[(2m + d) * kBlock + lane],
// so a warp reads 32 consecutive words; the grid Z is shared by all chains.
struct GPField {
  const float* sA;
  const float* sZ;     // sZ[2m + d]
  int lane;
  float sf2;           // sf^2
  float inv2ell2;      // 1 / (2 ell^2)
  float invell2;       // 1 / ell^2

  __device__ __forceinline__ float a(int m, int d) const {
    return sA[(2 * m + d) * kBlock + lane];
  }

  // f = K(y, Z) A at the N points.
  __device__ __forceinline__ void rhs(const float* y, float* f) const {
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const float px = y[2 * n], py = y[2 * n + 1];
      float fx = 0.f, fy = 0.f;
#pragma unroll 4
      for (int m = 0; m < kM; ++m) {
        const float dx = px - sZ[2 * m];
        const float dy = py - sZ[2 * m + 1];
        const float K = sf2 * expf(-(dx * dx + dy * dy) * inv2ell2);
        fx += K * a(m, 0);
        fy += K * a(m, 1);
      }
      f[2 * n] = fx;
      f[2 * n + 1] = fy;
    }
  }

  // Vector-Jacobian product at y for the cotangent `cot` of f(y):
  // ybar = (d f / d y)^T cot, and Abar += (d f / d A)^T cot, accumulated
  // into this chain's column of sAbar.  Z gets no cotangent.
  __device__ __forceinline__ void rhs_vjp(const float* y, const float* cot,
                                          float* ybar, float* sAbar) const {
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const float px = y[2 * n], py = y[2 * n + 1];
      const float cx = cot[2 * n], cy = cot[2 * n + 1];
      float ubx = 0.f, uby = 0.f;
#pragma unroll 4
      for (int m = 0; m < kM; ++m) {
        const float dx = px - sZ[2 * m];
        const float dy = py - sZ[2 * m + 1];
        const float K = sf2 * expf(-(dx * dx + dy * dy) * inv2ell2);
        sAbar[(2 * m) * kBlock + lane] += K * cx;
        sAbar[(2 * m + 1) * kBlock + lane] += K * cy;
        const float adotc = a(m, 0) * cx + a(m, 1) * cy;
        const float w = K * adotc * invell2;
        ubx += w * (-dx);
        uby += w * (-dy);
      }
      ybar[2 * n] = ubx;
      ybar[2 * n + 1] = uby;
    }
  }
};

// Stage this block's A rows (C, M, 2) into sA with coalesced loads; chains
// past C read as zero.  Z is copied once per block.
__device__ __forceinline__ void stage_weights(const float* __restrict__ A,
                                              const float* __restrict__ Z,
                                              int C, float* sA, float* sZ) {
  const int c0 = blockIdx.x * kBlock;
  for (int idx = threadIdx.x; idx < kBlock * 2 * kM; idx += kBlock) {
    const int l = idx / (2 * kM);
    const int j = idx - l * (2 * kM);
    sA[j * kBlock + l] =
        (c0 + l < C) ? A[static_cast<size_t>(c0) * 2 * kM + idx] : 0.f;
  }
  for (int idx = threadIdx.x; idx < 2 * kM; idx += kBlock) sZ[idx] = Z[idx];
}

// The GP field as the fused adaptive kernels take it (dopri5_kernels.cuh):
// weights A (C, M, 2) per chain and the grid Z (M, 2) shared by all
// chains; only A gets a cotangent.  One chain per thread; A and Z staged in
// shared memory, Abar accumulated per chain in shared memory and written
// once, with no atomics.
struct GPDopri5 {
  static constexpr int kNS = 2 * GP_N;
  static constexpr int kThreads = kBlock;
  static constexpr int kChains = kBlock;
  static constexpr bool kStageShared = false;
  struct Args {
    const float* A;
    const float* Z;
    float sf2, inv2ell2, invell2;
  };
  struct Grads {
    float* A;
  };
  struct Smem {
    float sA[2 * kM * kBlock];
    float sZ[2 * kM];
  };
  struct AccSmem {
    float sAbar[2 * kM * kBlock];
  };
  using Acc = float*;               // the block's sAbar

  GPField f;

  static __device__ int chain() { return blockIdx.x * kBlock + threadIdx.x; }
  static __device__ bool leader() { return true; }

  static __device__ GPDopri5 load(const Args& a, Smem& sm, int C, int) {
    stage_weights(a.A, a.Z, C, sm.sA, sm.sZ);
    __syncthreads();
    return GPDopri5{GPField{sm.sA, sm.sZ, static_cast<int>(threadIdx.x),
                            a.sf2, a.inv2ell2, a.invell2}};
  }
  static __device__ Acc acc_init(AccSmem& s) {
    for (int idx = threadIdx.x; idx < 2 * kM * kBlock; idx += kBlock)
      s.sAbar[idx] = 0.f;
    __syncthreads();
    return s.sAbar;
  }
  static __device__ void acc_store(const Acc& acc, const Grads& g, int c) {
    for (int j = 0; j < 2 * kM; ++j)
      g.A[static_cast<size_t>(c) * 2 * kM + j] = acc[j * kBlock + threadIdx.x];
  }

  __device__ void rhs(const float* y, float* out) const { f.rhs(y, out); }
  __device__ void rhs_vjp(const float* y, const float* cot, float* ybar,
                          Acc& acc) const {
    f.rhs_vjp(y, cot, ybar, acc);
  }
};

}  // namespace bode
