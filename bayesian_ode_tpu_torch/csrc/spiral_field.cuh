// The spiral y^3-net field as the fused adaptive kernels take it
// (dopri5_kernels.cuh):
//
//   f(y) = W2^T tanh(W1^T y^3 + b1) + b2,   y in R^2, H hidden units
//
// the reference spiral demo's learned dynamics with per-chain weights
// (bayesian_ode_tpu/ops/spiral_dopri5.py, whose VJP this copies).
//
// One warp per chain, ceil(H/32) hidden units a lane (lane l holds units
// l, l + 32, ...; units past H hold zero weights and add nothing): at H=50
// a lane keeps 12 weights and 12 cotangents in registers.  One thread per
// chain would leave 10,112 chains as about 77 threads an SM, 2-3 warps to
// hide the latency of 50 serial tanhf a point; a warp per chain puts about
// 77 warps on each SM and 2 tanhf a lane a point.
//
// What bounds the field on an H100 is the MIO pipe (shuffles and shared
// memory instructions, about one warp instruction a clock an SM) beside
// tanhf, so, as the MLP field (mlp_field.cuh), it spends few of those:
//   - the 2N output sums of an evaluation (f) or a VJP (ybar) are one
//     16-wide reduce-scatter (warp_sum16: 16 shuffles in place of 2N
//     butterflies of 5), which leaves component i on lane i (past N = 8
//     one 32-wide one, warp_sum32; N <= 16);
//   - every kernel carries one state component a lane (kOwn = 1: lane
//     i < 2N holds component i of every per-step array; lanes >= 2N mirror
//     component 2N-1 and write nothing).  The N points reach every lane
//     through the warp's shared copy of their 2N floats: in the forward
//     (K2) one copy, read back by 16-byte broadcast loads; in the reverse
//     sweeps one per stage slot (field_stages.cuh: slot 0 a step's y0,
//     slot r + 1 its u[r]);
//   - the stage slots also keep each stage point's tanh values, each
//     lane's units in its own column, so a VJP takes no second tanhf (on
//     an H100 recomputing them in the VJP made K3 27% slower).
// The forward's step decisions come from the error norm gathered from
// lanes 0..2N-1 (SpiralDopri5Fwd::norm_sums) in the per-chain order, the
// same bits on every lane; lanes 0..2N-1 write their components of the
// dense output and the records, lane 0 t0, dt and the counters.  Every
// __syncwarp() separates a lane's shared write from another lane's read:
// the lanes of a warp do not run in lockstep.
//
// Past N = 16, or where one warp's SpiralBuf<7> passes the 48 KB of
// static shared memory a block may have (H = 128 at N = 16), both
// kernels are built on spiral_wide_field.cuh instead (BODE_SPIRAL_WIDE):
// one warp and one chain a block, ceil(2N/32) components a lane, every
// buffer in dynamic shared memory.  The instances below those limits keep
// this file's design.
//
// tanhf is the full-precision one (no fast math).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "warp.cuh"

#ifndef SPIRAL_N
#error "SPIRAL_N (trajectory points per chain) must be defined at build time"
#endif
#ifndef SPIRAL_H
#error "SPIRAL_H (hidden width) must be defined at build time"
#endif

namespace bode {

constexpr int kSN = SPIRAL_N;
constexpr int kSNS = 2 * SPIRAL_N;            // state components per chain
constexpr int kSH = SPIRAL_H;
constexpr int kSU = (SPIRAL_H + 31) / 32;     // hidden units per lane
constexpr int kSVec = (kSNS + 3) / 4 * 4;

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

// A warp's shared memory: the kSlots kept points (and their tanh values)
// and the VJP's gathered cotangent.
template <int kSlots>
struct __align__(16) SpiralBuf {
  float pts[kSlots][kSVec];    // the kept points, gathered from their lanes
  float cot[kSVec];             // the VJP's cotangent, gathered likewise
  // tanh of unit lane + 32 k at point n of each kept point, at [n][k][lane]
  float h[kSlots][kSN][kSU][32];
};

// The forward's warp buffer: the gathered point, 48 B at N=5.
struct __align__(16) SpiralFwdBuf {
  float pts[kSVec];
};

// Chain c's weights w1 (C, 2, H), b1 (C, H), w2 (C, H, 2), b2 (C, 2), the
// layout of models/spiral.py's parameters: this lane's units into u (left
// as they are past H) and b2.
__device__ __forceinline__ void spiral_load(SpiralUnits& u, const float* w1,
                                            const float* b1, const float* w2,
                                            const float* b2, int c,
                                            int lane) {
  const size_t cc = static_cast<size_t>(c);
#pragma unroll
  for (int k = 0; k < kSU; ++k) {
    const int j = lane + 32 * k;
    if (j < kSH) {
      u.w1x[k] = w1[cc * 2 * kSH + j];
      u.w1y[k] = w1[cc * 2 * kSH + kSH + j];
      u.b1[k] = b1[cc * kSH + j];
      u.w2x[k] = w2[(cc * kSH + j) * 2];
      u.w2y[k] = w2[(cc * kSH + j) * 2 + 1];
    }
  }
  u.b2x = b2[cc * 2];
  u.b2y = b2[cc * 2 + 1];
}

// Chain c's weight cotangents from this lane's units, in the same layout
// (b2's from lane 0).
__device__ __forceinline__ void spiral_store(const SpiralUnits& u, float* w1,
                                             float* b1, float* w2, float* b2,
                                             int c, int lane) {
  const size_t cc = static_cast<size_t>(c);
#pragma unroll
  for (int k = 0; k < kSU; ++k) {
    const int j = lane + 32 * k;
    if (j < kSH) {
      w1[cc * 2 * kSH + j] = u.w1x[k];
      w1[cc * 2 * kSH + kSH + j] = u.w1y[k];
      b1[cc * kSH + j] = u.b1[k];
      w2[(cc * kSH + j) * 2] = u.w2x[k];
      w2[(cc * kSH + j) * 2 + 1] = u.w2y[k];
    }
  }
  if (lane == 0) {
    b2[cc * 2] = u.b2x;
    b2[cc * 2 + 1] = u.b2y;
  }
}

// The bytes of one warp's SpiralBuf<7> (a multiple of 16 as it stands),
// and whether the kernels take the wide design: past N = 16, or past 48 KB
// of static shared memory for one warp's buffer.
#define BODE_SPIRAL_BUF7 \
  (4 * (8 * ((2 * SPIRAL_N + 3) / 4 * 4) \
        + 7 * SPIRAL_N * ((SPIRAL_H + 31) / 32) * 32))
#define BODE_SPIRAL_WIDE (SPIRAL_N > 16 || BODE_SPIRAL_BUF7 > 48 * 1024)

}  // namespace bode

#if BODE_SPIRAL_WIDE
#include "spiral_wide_field.cuh"
#else

namespace bode {

static_assert(kSNS <= 32, "one state component a lane: N <= 16");
constexpr int kSSums = kSumWidth<kSNS>;    // warp_sum16, or 32 past N = 8

// kSlots > 0: the reverse sweeps' field, kSlots stage slots in
// SpiralBuf<kSlots>; kSlots = 0: the forward's, one gathered point in a
// SpiralFwdBuf.
template <int kSlots>
struct SpiralField {
  static constexpr bool kFwd = kSlots == 0;
  using Buf = std::conditional_t<kFwd, SpiralFwdBuf, SpiralBuf<kSlots>>;
  SpiralUnits w;
  Buf* b;                  // this warp's buffer
  int lane;

  // This lane's unit k at the cubed point (u, v).
  __device__ __forceinline__ float act(int k, float u, float v) const {
    return tanhf(w.w1x[k] * u + w.w1y[k] * v + w.b1[k]);
  }

  // f at the N points pt[2n], pt[2n + 1] (the same on every lane), its
  // tanh values kept in h[n][k][lane] where h is given: lane i (i < 2N)
  // returns f_i.
  __device__ __forceinline__ float eval(const float* pt,
                                        float (*h)[kSU][32]) const {
    float v[kSSums];
#pragma unroll
    for (int k = 0; k < kSSums; ++k) v[k] = 0.f;
#pragma unroll
    for (int n = 0; n < kSN; ++n) {
      const float x = pt[2 * n], yy = pt[2 * n + 1];
      const float u = x * x * x, vv = yy * yy * yy;
      float px = 0.f, py = 0.f;
#pragma unroll
      for (int k = 0; k < kSU; ++k) {
        const float hk = act(k, u, vv);
        if (h) h[n][k][lane] = hk;
        px += w.w2x[k] * hk;
        py += w.w2y[k] * hk;
      }
      v[2 * n] = px;
      v[2 * n + 1] = py;
    }
    return warp_sums(v, lane) + ((lane & 1) ? w.b2y : w.b2x);
  }

  // The forward's evaluation (SpiralField<0>): y[0] is component `lane`
  // of the point, f[0] returns f_lane.  The point is read back by 16-byte
  // broadcast loads, whose values feed eval's full-warp shuffles: no lane
  // writes the next point before every lane has read this one.
  __device__ __forceinline__ void rhs(const float* y, float* f) const {
    static_assert(kFwd, "the reverse sweeps evaluate through stage slots");
    if (lane < kSNS) b->pts[lane] = y[0];
    __syncwarp();
    float pt[kSVec];
#pragma unroll
    for (int i = 0; i < kSVec; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(&b->pts[i]);
      pt[i] = v.x;
      pt[i + 1] = v.y;
      pt[i + 2] = v.z;
      pt[i + 3] = v.w;
    }
    f[0] = eval(pt, nullptr);
  }

  // The reverse sweeps' evaluations (field_stages.cuh).  y, f, cot and
  // ybar are this lane's component: y[0] is component `lane` of the point.
  __device__ __forceinline__ const float* keep_point(int slot,
                                                     const float* y) const {
    float* pt = b->pts[slot];
    if (lane < kSNS) pt[lane] = y[0];
    __syncwarp();
    return pt;
  }

  __device__ __forceinline__ void stage_hidden(int slot,
                                               const float* y) const {
    const float* pt = keep_point(slot, y);
#pragma unroll
    for (int n = 0; n < kSN; ++n) {
      const float x = pt[2 * n], yy = pt[2 * n + 1];
      const float u = x * x * x, vv = yy * yy * yy;
#pragma unroll
      for (int k = 0; k < kSU; ++k) b->h[slot][n][k][lane] = act(k, u, vv);
    }
  }

  __device__ __forceinline__ void stage_rhs(int slot, const float* y,
                                            float* f) const {
    f[0] = eval(keep_point(slot, y), b->h[slot]);
  }

  // ybar = (df/dy)^T cot at the point kept in `slot`, and the weight
  // cotangents of this lane's units accumulated into g (b2's by every lane
  // alike; lane 0 stores it).
  __device__ __forceinline__ void stage_vjp(int slot, const float*,
                                            const float* cot, float* ybar,
                                            SpiralUnits& g) const {
    if (lane < kSNS) b->cot[lane] = cot[0];
    __syncwarp();
    const float* pt = b->pts[slot];
    float v[kSSums];
#pragma unroll
    for (int k = 0; k < kSSums; ++k) v[k] = 0.f;
#pragma unroll
    for (int n = 0; n < kSN; ++n) {
      const float x = pt[2 * n], yy = pt[2 * n + 1];
      const float cx = b->cot[2 * n], cy = b->cot[2 * n + 1];
      const float u = x * x * x, vv = yy * yy * yy;
      float sx = 0.f, sy = 0.f;
#pragma unroll
      for (int k = 0; k < kSU; ++k) {
        const float hk = b->h[slot][n][k][lane];
        g.w2x[k] += hk * cx;
        g.w2y[k] += hk * cy;
        const float hb = w.w2x[k] * cx + w.w2y[k] * cy;
        const float a1b = hb * (1.0f - hk * hk);    // tanh' = 1 - tanh^2
        g.b1[k] += a1b;
        g.w1x[k] += u * a1b;
        g.w1y[k] += vv * a1b;
        sx += w.w1x[k] * a1b;
        sy += w.w1y[k] * a1b;
      }
      g.b2x += cx;
      g.b2y += cy;
      v[2 * n] = sx;
      v[2 * n + 1] = sy;
    }
    // d(y^3)/dy = 3 y^2, at this lane's component
    const float yi = pt[lane < kSNS ? lane : kSNS - 1];
    ybar[0] = 3.0f * yi * yi * warp_sums(v, lane);
    __syncwarp();     // cot and the point read before the next writes
  }
};

// What the spiral field's two adaptive kernels share (dopri5_kernels.cuh):
// one warp per chain, kC chains a block, lane i < 2N carrying component i
// (lanes past it mirror the last), lane 0 the chain's leader.  Weights w1
// (C, 2, H), b1 (C, H), w2 (C, H, 2), b2 (C, 2), the layout of
// models/spiral.py's parameters.
template <int kC, int kSlots>
struct SpiralWarpChains {
  static constexpr int kNS = kSNS;
  static constexpr int kOwn = 1;
  static constexpr int kChains = kC;
  static constexpr int kThreads = 32 * kC;
  struct Args {
    const float *w1, *b1, *w2, *b2;
  };
  struct Smem {
    typename SpiralField<kSlots>::Buf warp[kC];
  };

  SpiralField<kSlots> f;

  static __device__ int chain() {
    return blockIdx.x * kChains + (threadIdx.x >> 5);
  }
  static __device__ bool leader() { return (threadIdx.x & 31) == 0; }
  static __device__ int comp(int) {
    const int lane = threadIdx.x & 31;
    return lane < kSNS ? lane : kSNS - 1;
  }
  static __device__ bool owner() { return (threadIdx.x & 31) < kSNS; }

  // this lane's units of chain c's weights (zeros past the last chain) and
  // its warp's buffer
  __device__ void load_weights(const Args& a, Smem& sm, int C, int c) {
    f.lane = threadIdx.x & 31;
    f.b = &sm.warp[threadIdx.x >> 5];
    spiral_zero(f.w);
    if (c >= C) return;
    spiral_load(f.w, a.w1, a.b1, a.w2, a.b2, c, f.lane);
  }
};

// The forward (K2, with and without records): 4 chains a block, a warp's
// buffer 48 B at N=5.
struct SpiralDopri5Fwd : SpiralWarpChains<4, 0> {
  // 32 warps an SM: 64 registers, no spills (at 6 blocks ptxas takes 70
  // registers, 28 warps an SM, for the same time on an H100)
  static constexpr int kMinBlocks = 8;
  static __device__ SpiralDopri5Fwd load(const Args& a, Smem& sm, int C,
                                         int c) {
    SpiralDopri5Fwd s;
    s.load_weights(a, sm, C, c);
    return s;
  }

  // The error norm's sums (field_stages.cuh): component i's ratio from
  // lane i, added as the per-chain loop adds them (dopri5_common.cuh,
  // step_decision: even i into sx, odd into sy, ascending), so every lane
  // takes the same step decision.  The warp is one chain and stays in its
  // loop as a whole, so every lane takes part.
  __device__ __forceinline__ void norm_sums(const float* r, float& sx,
                                            float& sy) const {
#pragma unroll
    for (int i = 0; i < kSNS; ++i) {
      const float ri = __shfl_sync(kFull, r[0], i);
      if (i % 2 == 0) sx += ri * ri; else sy += ri * ri;
    }
  }

  __device__ void rhs(const float* y, float* out) const { f.rhs(y, out); }
};

// The backward (K3): the 7 stage points of a step in slots 0 (y0) to 6
// (u[5]); as many chains a block (at most 4) as keep the block's warp
// buffers within the 48 KB of static shared memory (4 at N=5, H=50:
// 9,344 B a warp; 2 at N=9, H=50: 16,768 B; 1 at N=16: 29,696 B).
struct SpiralDopri5
    : SpiralWarpChains<warps_fitting(4, sizeof(SpiralBuf<7>)), 7> {
  static constexpr int kStageSlots = 7;
  struct Grads {
    float *w1, *b1, *w2, *b2;
  };
  struct AccSmem {};
  using Acc = SpiralUnits;

  static __device__ SpiralDopri5 load(const Args& a, Smem& sm, int C, int c) {
    SpiralDopri5 s;
    s.load_weights(a, sm, C, c);
    return s;
  }
  static __device__ Acc acc_init(AccSmem&) {
    SpiralUnits u;
    spiral_zero(u);
    return u;
  }
  static __device__ void acc_store(const Acc& acc, const Grads& g, int c) {
    spiral_store(acc, g.w1, g.b1, g.w2, g.b2, c, threadIdx.x & 31);
  }

  __device__ void stage_rhs(int slot, const float* y, float* out) const {
    f.stage_rhs(slot, y, out);
  }
  __device__ void stage_hidden(int slot, const float* y) const {
    f.stage_hidden(slot, y);
  }
  __device__ void stage_vjp(int slot, const float* y, const float* cot,
                            float* ybar, Acc& acc) const {
    f.stage_vjp(slot, y, cot, ybar, acc);
  }
};

}  // namespace bode

#endif  // BODE_SPIRAL_WIDE
