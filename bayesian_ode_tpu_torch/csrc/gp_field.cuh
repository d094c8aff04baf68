// The GP kernel-regression field as functors:
//
//   f(x_n) = sum_m sf^2 exp(-|x_n - z_m|^2 / (2 ell^2)) A_m
//
// GPPoint carries one trajectory point per thread, for the whole adaptive
// solves (K1, K2: dopri5_kernels.cuh over gp_dopri5_fwd.cu), the per-step
// solver's output intervals (K9, over gp_dopri5_step.cu), the rk4 forward
// (K4, gp_rk4.cu) and the reverse sweeps (K3, over gp_dopri5_bwd.cu; K5,
// gp_rk4.cu).  State layout per chain: 2 * GP_N floats, y[2n + d] (the
// JAX (N, 2) layout).  The rk4 forward's steps are on the output grid, so
// its N points step independently too.  f at point n
// reads only x_n and the chain's A.  The reverse sweeps' step mesh is
// frozen (K3 replays recorded steps, K5 steps on the output grid), so the
// sweeps of a chain's N points are independent: they share only the A
// they read and the Abar they add to.  The adaptive forwards share one
// thing more: the error norm over all 2N components, which picks each
// step.  norm_sums gathers the chain's ratios by shuffles and sums them in
// the per-chain order, so every thread of the chain takes the step the
// per-chain solve takes, bit for bit.
//
// GPPoint keeps its block's buffers (A, Z and the Abar columns) in dynamic
// shared memory (kDynamicSmem, field_stages.cuh): they grow with the
// inducing grid, past the 48 KB of static shared memory a block may have
// from a 7x7 grid on in K3 (51,784 B at N = 5) and 8x8 in K5.  Past
// N = 32, or where a kernel's GPPoint block would pass the 232,448 B a
// block may take, that kernel runs on GPWidePoint (gp_wide_field.cuh)
// instead: GPFwdPoint, GPReplayPoint and GPRk4Point below pick one of the
// two at compile time (gp_narrow).  ops/_build.py's check_shape holds
// every instance to N <= 128, M <= 1,024 and its block's limit before the
// build.
//
// Full float32 throughout: built without --use_fast_math and with expf.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "warp.cuh"

#ifndef GP_N
#error "GP_N (trajectory points per chain) must be defined at build time"
#endif
#ifndef GP_M
#error "GP_M (inducing points) must be defined at build time"
#endif

namespace bode {

constexpr int kN = GP_N;
constexpr int kM = GP_M;
constexpr int kNS = 2 * GP_N;    // state components per chain

// The pieces GPPoint and GPWidePoint (gp_wide_field.cuh) share: the
// block's staging of A and Z, the field and one term of its VJP at one
// trajectory point (a chain's A column at sA[m * kStride]), and the error
// norm's sums over a chain's lanes of one warp.

// Stage the block's A rows (C, M, 2) as float2 columns sA[m * kChains +
// chain in block] with coalesced loads (chains past C read as zero), and
// Z; called by every thread of the block, which it leaves at a barrier.
template <int kChains, int kThreads>
__device__ __forceinline__ void gp_stage(const float* A, const float* Z,
                                         float2* sA2, float2* sZ2, int C) {
  const int c0 = blockIdx.x * kChains;
  float* sA = reinterpret_cast<float*>(sA2);
  for (int idx = threadIdx.x; idx < kChains * 2 * kM; idx += kThreads) {
    const int l = idx / (2 * kM);
    const int j = idx - l * (2 * kM);
    sA[((j >> 1) * kChains + l) * 2 + (j & 1)] =
        (c0 + l < C) ? A[static_cast<size_t>(c0) * 2 * kM + idx] : 0.f;
  }
  float* sZ = reinterpret_cast<float*>(sZ2);
  for (int idx = threadIdx.x; idx < 2 * kM; idx += kThreads) sZ[idx] = Z[idx];
  __syncthreads();
}

// f = K(y, Z) A at the point y[0..1], each sum in ascending order over m.
// The m loop unrolled by 12, not 4: on an H100 the solves K1/K2 took less
// time, K3 and K5 the same, and the sums are the same bit for bit.
template <int kStride>
__device__ __forceinline__ void gp_rhs(const float2* sA, const float2* sZ,
                                       float sf2, float inv2ell2,
                                       const float* y, float* f) {
  const float px = y[0], py = y[1];
  float fx = 0.f, fy = 0.f;
#pragma unroll 12
  for (int m = 0; m < kM; ++m) {
    const float2 z = sZ[m];
    const float dx = px - z.x;
    const float dy = py - z.y;
    const float K = sf2 * expf(-(dx * dx + dy * dy) * inv2ell2);
    const float2 am = sA[m * kStride];
    fx += K * am.x;
    fy += K * am.y;
  }
  f[0] = fx;
  f[1] = fy;
}

// One inducing point's term of the VJP at (px, py) for the cotangent
// (cx, cy): its Abar share goes to (ax, ay), its ybar share to (ubx, uby).
template <int kStride>
__device__ __forceinline__ void gp_vjp_term(
    const float2* sA, const float2* sZ, float sf2, float inv2ell2,
    float invell2, int m, float px, float py, float cx, float cy, float& ax,
    float& ay, float& ubx, float& uby) {
  const float2 z = sZ[m];
  const float dx = px - z.x;
  const float dy = py - z.y;
  const float K = sf2 * expf(-(dx * dx + dy * dy) * inv2ell2);
  ax += K * cx;
  ay += K * cy;
  const float2 am = sA[m * kStride];
  const float adotc = am.x * cx + am.y * cy;
  const float w = K * adotc * invell2;
  ubx += w * (-dx);
  uby += w * (-dy);
}

// The error norm's sums (field_stages.cuh): point q's ratios r[0] (x) and
// r[1] (y) from lane base + q, added as the per-chain loop adds them
// (dopri5_common.cuh, step_decision), q = 0..N-1.  Every lane of `mask`
// (the chain's) gets the same bits; only they take part, so chains that
// have finished their solves need not.
__device__ __forceinline__ void gp_warp_norm_sums(unsigned mask, int base,
                                                  const float* r, float& sx,
                                                  float& sy) {
#pragma unroll
  for (int q = 0; q < kN; ++q) {
    const float rx = __shfl_sync(mask, r[0], base + q);
    const float ry = __shfl_sync(mask, r[1], base + q);
    sx += rx * rx;
    sy += ry * ry;
  }
}

// One trajectory point per thread: the GP field of the whole adaptive
// solves, the per-step solver and the reverse sweeps (K1, K2, K9 and K3,
// as the kernels of dopri5_kernels.cuh take it; K4 and K5, gp_rk4.cu).
//
// Lanes: N consecutive lanes carry one chain, lane = N * (chain in warp) +
// n, so a warp holds 32 / N chains (6 at N = 5, lanes 30-31 idle) and a
// chain never crosses a warp.  A thread carries its point's 2 components
// (kOwn, comp(q) = 2n + q) and reads and writes only those of the records,
// g and lbar; neighbouring lanes read neighbouring words, so those loads
// coalesce.
//
// rhs and rhs_vjp are the field's expressions at one point, each sum in
// ascending order over m, as one chain a thread evaluated them, so the
// stage values, ybar and the x0 cotangent are that design's bit for bit.
// Abar: each thread sums its own point's share, for the first R inducing
// points in registers (the m loop over them is unrolled, so every index
// is a constant) and for the rest in its own column of shared memory (a
// float2 a point, sAbar[(m - R) * kThreads + thread]: a warp's 32 columns
// are 256 consecutive bytes).  acc_store adds the N partials of a chain
// by shuffles inside the warp, in ascending n: the sum over points is the
// only reassociation.  A chain's A sits in
// shared memory as float2 columns sA[m * kChains + chain in block]: the N
// lanes of a chain read one word (a broadcast) and the chains of a warp
// neighbouring words.
//
// The forwards carry the same 2 components a thread through the step
// arithmetic (dopri5_common.cuh is per component) and write them to the
// dense output and the records; the chain's lane n = 0 (leader) writes t0,
// dt and the counters.  Their rhs is the same one point's, so their
// stages are the per-chain solve's; norm_sums makes their decisions its
// decisions.  K9 steps the same way, one output interval a launch, and
// carries its point's quartic coefficients between launches.
//
// The rk4 forward (K4) is the forwards' pattern with no norm: a thread
// steps its own point through rk4_step<2> and writes its 2 components.
//
// 128 threads a block (24 chains at N = 5) and at most 128 registers a
// thread (__launch_bounds__ with kMinBlocks = 4): 10,112 chains are 422
// blocks, under one wave of 4 blocks on each of 132 SMs (0.80 waves).
// The block's buffers are dynamic (kDynamicSmem): 200 B an inducing point
// for A and Z at N = 5, and 1,024 B for each one past R in Abar's columns.
template <int R>
struct GPPoint {
  // (on R, so that it holds where GPPoint<R> is used, not where named)
  static_assert(R > 0 && kN >= 1 && kN <= 32,
                "a chain's points must fit one warp");
  static_assert(R > 0, "R inducing points in registers");
  static constexpr int kR = R < kM ? R : kM;    // at most all of them
  static constexpr int kNS = 2 * GP_N;      // a chain's state components
  static constexpr int kOwn = 2;            // a thread's: its point's x, y
  static constexpr int kChainsPerWarp = 32 / kN;
  static constexpr int kThreads = 128;
  static constexpr int kChains = kThreads / 32 * kChainsPerWarp;
  static constexpr int kMinBlocks = 4;
  // acc_store sums over the warp's lanes: every lane of the warp calls it
  static constexpr bool kWarpStore = true;
  static constexpr bool kDynamicSmem = true;
  struct Args {
    const float* A;
    const float* Z;
    float sf2, inv2ell2, invell2;
  };
  struct Grads {
    float* A;
  };
  struct Smem {
    float2 sA[kM * kChains];
    float2 sZ[kM];
  };
  struct AccSmem {
    float2 sAbar[(kM - kR) * kThreads + (kR == kM)];  // + 1: never empty
  };
  struct Acc {
    float v[2 * kR];   // Abar of this point, v[2m + d], m < kR
    float2* s;         // and its column, s[(m - kR) * kThreads]
  };

  const float2* sA;      // this chain's column: sA[m * kChains]
  const float2* sZ;
  float sf2, inv2ell2, invell2;

  static __device__ int lane() { return threadIdx.x & 31; }
  static __device__ int point() { return lane() % kN; }
  // this thread's chain; a lane past the warp's last chain has none
  // (returns a count past any C)
  static __device__ int chain() {
    return lane() < kChainsPerWarp * kN
               ? blockIdx.x * kChains + (threadIdx.x >> 5) * kChainsPerWarp
                     + lane() / kN
               : 0x7fffffff;
  }
  static __device__ int comp(int q) { return 2 * point() + q; }
  static __device__ bool owner() { return true; }
  static __device__ bool leader() { return point() == 0; }
  // the lanes of this thread's chain
  static __device__ unsigned chain_mask() {
    const unsigned m = kN == 32 ? kFull : (1u << (kN % 32)) - 1u;
    return m << (lane() - point());
  }

  // Stage the block's A and Z (gp_stage); called by every thread of the
  // block.
  static __device__ GPPoint load(const Args& a, Smem& sm, int C, int) {
    gp_stage<kChains, kThreads>(a.A, a.Z, sm.sA, sm.sZ, C);
    const int w = min(lane() / kN, kChainsPerWarp - 1);   // idle lanes: any
    return GPPoint{sm.sA + (threadIdx.x >> 5) * kChainsPerWarp + w, sm.sZ,
                   a.sf2, a.inv2ell2, a.invell2};
  }
  // Only this thread touches its column, so it needs no barrier.
  static __device__ Acc acc_init(AccSmem& s) {
    Acc acc{};
    acc.s = s.sAbar + threadIdx.x;
    for (int m = kR; m < kM; ++m)
      acc.s[(m - kR) * kThreads] = float2{0.f, 0.f};
    return acc;
  }

  // Abar of chain c, the sum of its N points' partials in ascending n,
  // written by the chain's lane n = 0.  A warp collective: every lane of
  // the warp calls it, one with no chain with c < 0 (it writes nothing).
  static __device__ void acc_store(const Acc& acc, const Grads& g, int c) {
    const bool lead = c >= 0 && point() == 0;
    float* out = g.A + static_cast<size_t>(c < 0 ? 0 : c) * 2 * kM;
#pragma unroll
    for (int j = 0; j < 2 * kR; ++j) {
      float s = acc.v[j];
#pragma unroll
      for (int q = 1; q < kN; ++q) s += __shfl_down_sync(kFull, acc.v[j], q);
      if (lead) out[j] = s;
    }
#pragma unroll 2
    for (int m = kR; m < kM; ++m) {
      const float2 v = acc.s[(m - kR) * kThreads];
      float sx = v.x, sy = v.y;
#pragma unroll
      for (int q = 1; q < kN; ++q) {
        sx += __shfl_down_sync(kFull, v.x, q);
        sy += __shfl_down_sync(kFull, v.y, q);
      }
      if (lead) {
        out[2 * m] = sx;
        out[2 * m + 1] = sy;
      }
    }
  }

  // The error norm's sums over the chain's lanes (gp_warp_norm_sums).
  __device__ __forceinline__ void norm_sums(const float* r, float& sx,
                                            float& sy) const {
    gp_warp_norm_sums(chain_mask(), lane() - point(), r, sx, sy);
  }

  // f = K(y, Z) A at this thread's point y[0..1].
  __device__ __forceinline__ void rhs(const float* y, float* f) const {
    gp_rhs<kChains>(sA, sZ, sf2, inv2ell2, y, f);
  }

  __device__ __forceinline__ void vjp_term(int m, float px, float py,
                                           float cx, float cy, float& ax,
                                           float& ay, float& ubx,
                                           float& uby) const {
    gp_vjp_term<kChains>(sA, sZ, sf2, inv2ell2, invell2, m, px, py, cx, cy,
                         ax, ay, ubx, uby);
  }

  // Vector-Jacobian product at this point y for the cotangent `cot` of
  // f(y): ybar = (d f / d y)^T cot, and Abar += (d f / d A)^T cot, into
  // this thread's registers and column.  Z gets no cotangent.
  __device__ __forceinline__ void rhs_vjp(const float* y, const float* cot,
                                          float* ybar, Acc& acc) const {
    const float px = y[0], py = y[1];
    const float cx = cot[0], cy = cot[1];
    float ubx = 0.f, uby = 0.f;
#pragma unroll
    for (int m = 0; m < kR; ++m)
      vjp_term(m, px, py, cx, cy, acc.v[2 * m], acc.v[2 * m + 1], ubx, uby);
#pragma unroll 4
    for (int m = kR; m < kM; ++m) {
      float2 a = acc.s[(m - kR) * kThreads];
      vjp_term(m, px, py, cx, cy, a.x, a.y, ubx, uby);
      acc.s[(m - kR) * kThreads] = a;
    }
    ybar[0] = ubx;
    ybar[1] = uby;
  }
};

}  // namespace bode

#include "gp_wide_field.cuh"

namespace bode {

// The bytes of a GPPoint<R> block (ops/_build.py, smem_bytes): A and Z,
// and the sweeps' Abar columns past R where `acc`.
constexpr long gp_narrow_bytes(int R, bool acc) {
  const long chains = 4L * (kN <= 32 ? 32 / kN : 1);
  const long kR = R < kM ? R : kM;
  return 8L * (kM * chains + kM)
         + (acc ? 8L * ((kM - kR) * 128 + (kR == kM)) : 0L);
}
// Whether a kernel's GPPoint<R> block fits: N <= 32 and its buffers
// within a block's dynamic shared memory.
constexpr bool gp_narrow(int R, bool acc) {
  return kN <= 32 && gp_narrow_bytes(R, acc) <= kGPSmemMax;
}
template <int R, bool kAcc>
using GPPointFor =
    std::conditional_t<gp_narrow(R, kAcc), GPPoint<R>, GPWidePoint>;

// The inducing points whose Abar a thread keeps in registers: the most
// that fit 128 registers beside the sweep's stage arrays (13 live a point
// in K3's replay, 7 in K5's rk4 step) with no spills.  On an H100 at
// 10,112 chains: K3 at DOPRI5 1.23 ms with R = 8, against 1.33 ms with
// Abar all in shared memory (85 registers) and 1.28 ms at R = 12, which
// spills; K5 0.94 ms at R = 12, against 1.02 ms with Abar all in shared
// memory (63 registers), and spills past it.  A grid of M < R inducing
// points keeps them all in registers.  The forwards (K1, K2, K4) and K9
// keep no Abar, so R does not reach them: they take GPPoint<8>'s code,
// and one type, so that all four take the same steps.
using GPFwdPoint = GPPointFor<8, false>;      // K1, K2, K4, K9
using GPReplayPoint = GPPointFor<8, true>;    // K3
using GPRk4Point = GPPointFor<12, true>;      // K5

}  // namespace bode
