// The FitzHugh-Nagumo theta-field as the fused adaptive kernels take it
// (dopri5_kernels.cuh):
//
//   V' = c (V - V^3/3 + R),   R' = -(V - a + b R) / c,   theta = (a, b, c)
//
// per chain, as bayesian_ode_tpu/ops/fhn_dopri5.py registers it on the
// public engine.  theta sits in registers; the field multiplies by
// inv_c = 1/c, computed once per chain, as the TPU kernel does (the host
// reference of ops/fhn_dopri5.py divides by c).  At three weights a chain,
// the kernels are bound by the serial latency of their step chain and by
// the bytes of the dense output and records.
//
// The field is pointwise: f at point n reads only that point's V and R and
// theta.  So the kernels (K2 and K3, FHNPoint) carry one trajectory point a
// thread, N consecutive lanes a chain, as the GP field's solves and sweeps
// do (gp_field.cuh, GPPoint): a thread's serial chain is one point's, not
// N points', and 10,112 chains are 1,686 warps where one chain a thread
// made 316.  In the forward the error norm is the only chain-wide step:
// norm_sums gathers the chain's ratios by shuffles and adds them in the
// per-chain order, so the trajectories, counters and records are the
// per-chain solve's bit for bit.  In the replay backward the mesh is
// frozen, so the chain's sweep is the sum of its N one-point sweeps: they
// share only theta's cotangent, which acc_store sums over the chain's
// lanes in ascending n (the only reassociation; the x0 cotangent is the
// per-chain sweep's bit for bit).  Past 32 points a chain does not fit a
// warp, and both kernels are built on FHNDopri5, one chain a thread
// (FHNFwd, FHNBwd, chosen by N).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "warp.cuh"

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

  // f at one point (V, R) = (x, r).
  __device__ __forceinline__ void point_rhs(float x, float r, float& fx,
                                            float& fy) const {
    const float s = x - x * x * x * kThird + r;   // V' = c s
    const float q = x - a + b * r;                // R' = -q / c
    fx = c * s;
    fy = -q * inv_c;
  }

  __device__ void rhs(const float* y, float* f) const {
#pragma unroll
    for (int n = 0; n < kFN; ++n)
      point_rhs(y[2 * n], y[2 * n + 1], f[2 * n], f[2 * n + 1]);
  }

  // The VJP at one point (V, R) = (x, r) for the cotangent (cx, cy) of
  // f there: (xb, yb) = (df/dy)^T cot, and theta's cotangent added to acc:
  //   d fy/da = 1/c, d fy/db = -R/c, d fy/dc = q/c^2, d fx/dc = s;
  //   d fx/dV = c (1 - V^2), d fx/dR = c, d fy/dV = -1/c, d fy/dR = -b/c.
  __device__ __forceinline__ void point_vjp(float x, float r, float cx,
                                            float cy, float& xb, float& yb,
                                            Acc& acc) const {
    const float s = x - x * x * x * kThird + r;
    const float q = x - a + b * r;
    acc.a = acc.a + cy * inv_c;
    acc.b = acc.b - cy * r * inv_c;
    acc.c = acc.c + cx * s + cy * q * inv_c * inv_c;
    xb = cx * c * (1.0f - x * x) - cy * inv_c;
    yb = cx * c - cy * b * inv_c;
  }

  // ybar = (df/dy)^T cot at the chain's N points, in ascending n.
  __device__ void rhs_vjp(const float* y, const float* cot, float* ybar,
                          Acc& acc) const {
#pragma unroll
    for (int n = 0; n < kFN; ++n)
      point_vjp(y[2 * n], y[2 * n + 1], cot[2 * n], cot[2 * n + 1],
                ybar[2 * n], ybar[2 * n + 1], acc);
  }
};

// The field of the forward (K2, with and without records) and of the
// replay backward (K3) at N <= 32: one trajectory point a thread.  kOwn =
// 2: a thread carries its point's V and R (components 2n and 2n + 1);
// 32 / N chains a warp, 128 threads a block (24 chains at N = 5: 422
// blocks at 10,112 chains, all resident at once); the chain's lane n = 0
// writes t0, dt and the counters, and theta's cotangent.  In K3 a thread
// sweeps its own point's records and keeps its share of theta's
// cotangent in registers (Acc); acc_store adds the chain's N shares.
template <int N>
struct FHNPoint {
  static_assert(N >= 1 && N <= 32, "a chain's points must fit one warp");
  static constexpr int kNS = 2 * N;
  static constexpr int kOwn = 2;
  static constexpr int kChainsPerWarp = 32 / N;
  static constexpr int kThreads = 128;
  static constexpr int kChains = kThreads / 32 * kChainsPerWarp;
  static constexpr int kMinBlocks = 4;
  // acc_store sums over the warp's lanes: every lane of the warp calls it
  static constexpr bool kWarpStore = true;
  using Args = FHNDopri5::Args;
  using Grads = FHNDopri5::Grads;
  using Smem = FHNDopri5::Smem;
  using AccSmem = FHNDopri5::AccSmem;
  using Acc = FHNDopri5::Acc;

  FHNDopri5 th;        // the chain's theta

  static __device__ int lane() { return threadIdx.x & 31; }
  static __device__ int point() { return lane() % N; }
  // this thread's chain; a lane past the warp's last chain has none
  // (returns a count past any C)
  static __device__ int chain() {
    return lane() < kChainsPerWarp * N
               ? blockIdx.x * kChains + (threadIdx.x >> 5) * kChainsPerWarp
                     + lane() / N
               : 0x7fffffff;
  }
  static __device__ int comp(int q) { return 2 * point() + q; }
  static __device__ bool owner() { return true; }
  static __device__ bool leader() { return point() == 0; }
  // the lanes of this thread's chain
  static __device__ unsigned chain_mask() {
    const unsigned m = N == 32 ? kFull : (1u << (N % 32)) - 1u;
    return m << (lane() - point());
  }

  static __device__ FHNPoint load(const Args& w, Smem& sm, int C, int ch) {
    return FHNPoint{FHNDopri5::load(w, sm, C, ch)};
  }
  static __device__ Acc acc_init(AccSmem& s) {
    return FHNDopri5::acc_init(s);
  }

  // theta's cotangent of chain c, the sum of its N points' shares in
  // ascending n, written by the chain's lane n = 0.  A warp collective:
  // every lane of the warp calls it, one with no chain with c < 0 (it
  // writes nothing).
  static __device__ void acc_store(const Acc& acc, const Grads& g, int c) {
    float sa = acc.a, sb = acc.b, sc = acc.c;
#pragma unroll
    for (int q = 1; q < N; ++q) {
      sa += __shfl_down_sync(kFull, acc.a, q);
      sb += __shfl_down_sync(kFull, acc.b, q);
      sc += __shfl_down_sync(kFull, acc.c, q);
    }
    if (c >= 0 && point() == 0) FHNDopri5::acc_store(Acc{sa, sb, sc}, g, c);
  }

  // The error norm's sums (field_stages.cuh): point q's ratios r[0] (V)
  // and r[1] (R) from the chain's lane q, added as the per-chain loop adds
  // them (dopri5_common.cuh, step_decision), q = 0..N-1.  Every thread of
  // the chain gets the same bits; only the chain's lanes take part, so
  // chains that have finished their solves need not.
  __device__ __forceinline__ void norm_sums(const float* r, float& sx,
                                            float& sy) const {
    const unsigned mask = chain_mask();
    const int base = lane() - point();
#pragma unroll
    for (int q = 0; q < N; ++q) {
      const float rx = __shfl_sync(mask, r[0], base + q);
      const float ry = __shfl_sync(mask, r[1], base + q);
      sx += rx * rx;
      sy += ry * ry;
    }
  }

  // f at this thread's point y[0..1].
  __device__ void rhs(const float* y, float* f) const {
    th.point_rhs(y[0], y[1], f[0], f[1]);
  }

  // The VJP at this thread's point y[0..1], FHNDopri5's at one point.
  __device__ void rhs_vjp(const float* y, const float* cot, float* ybar,
                          Acc& acc) const {
    th.point_vjp(y[0], y[1], cot[0], cot[1], ybar[0], ybar[1], acc);
  }
};

// The kernels' field: one point a thread where a chain fits a warp, one
// chain a thread past it (a choice of the build's shape, N).
using FHNFwd =
    std::conditional_t<(kFN <= 32), FHNPoint<kFN>, FHNDopri5>;
using FHNBwd = FHNFwd;

}  // namespace bode
