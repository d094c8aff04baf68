// The spiral field past one warp's lanes or a block's static shared
// memory: N > 16 (to N = 64) or one warp's SpiralBuf<7> past 48 KB (H = 128
// at N = 16), to H = 256 where a block's buffer fits 232,448 B of dynamic
// shared memory.  spiral_field.cuh includes it for those shapes in place of
// its own design, which the instances below those limits keep.
//
// Still one warp per chain, now one chain a block (32 threads), every
// buffer in dynamic shared memory (kDynamicSmem, field_stages.cuh): the
// sweep's seven stage slots keep each point's tanh values, 7 x N x
// ceil(H/32) x 128 B a chain (114,688 B at N = 32, H = 128).
//   - State components: kSOwn = ceil(2N/32) a lane, lane l carrying
//     components l, l + 32, ... (spiral_comp; past 2N - 1 a mirror of the
//     last, written nowhere: owns(q)).
//   - The 2N output sums of an evaluation or a VJP: kSOwn sums over the
//     warp, one a chunk of 16 points (warp_sum32; one warp_sums of the
//     narrow design's width where kSOwn = 1), which leave component
//     32 q + l on lane l.  The points reach every lane through the warp's
//     shared copy, read chunk by chunk.
//   - Hidden units as spiral_field.cuh: ceil(H/32) a lane, each sum over
//     a lane's units in the same order, then over the lanes.
// The forward's error norm gathers the 2N ratios in the per-chain order,
// every lane the same bits (norm_sums).  A __syncwarp() separates every
// shared write from another lane's read and every read from the next
// overwrite.  Past N = 16 the evaluations are compiled once and called
// (BODE_SPIRAL_WIDE_EVAL), not inlined into every stage of a step, as
// mlp_wide_field.cuh does past N = 16 for nvcc's time.
#pragma once

#if SPIRAL_N > 16
#define BODE_SPIRAL_WIDE_EVAL __device__ __noinline__
#else
#define BODE_SPIRAL_WIDE_EVAL __device__ __forceinline__
#endif

namespace bode {

static_assert(kSN <= 64 && kSH <= 256,
              "the wide spiral field takes N <= 64 and H <= 256");
constexpr int kSOwn = (kSNS + 31) / 32;      // state components a lane
// the width of one chunk's output sums: its 2 x 16 points' components, or
// where one chunk holds them all, the narrow design's width
constexpr int kSChunk = kSOwn == 1 ? kSumWidth<kSNS> : 32;
constexpr int kSChunkPoints = kSChunk / 2;

// This lane's q-th state component (a mirror of the last past 2N - 1).
__device__ __forceinline__ int spiral_comp(int lane, int q) {
  const int i = 32 * q + lane;
  return i < kSNS ? i : kSNS - 1;
}

// A lane's kSOwn values of an evaluation or a VJP.
struct SpiralOwn {
  float v[kSOwn];
};

// kSlots > 0: the reverse sweep's field, kSlots stage slots in
// SpiralBuf<kSlots>; kSlots = 0: the forward's, a SpiralFwdBuf.
template <int kSlots>
struct SpiralWideField {
  static constexpr bool kFwd = kSlots == 0;
  using Buf = std::conditional_t<kFwd, SpiralFwdBuf, SpiralBuf<kSlots>>;
  SpiralUnits w;
  Buf* b;                  // the chain's buffer
  int lane;

  __device__ __forceinline__ float act(int k, float u, float v) const {
    return tanhf(w.w1x[k] * u + w.w1y[k] * v + w.b1[k]);
  }

  // f at the N points pt[2n], pt[2n + 1] (shared, the same on every
  // lane), its tanh values kept in h[n][k][lane] where h is given: v[q]
  // is f of component spiral_comp(lane, q).
  BODE_SPIRAL_WIDE_EVAL SpiralOwn eval(const float* pt,
                                       float (*h)[kSU][32]) const {
    SpiralOwn f;
#pragma unroll
    for (int q = 0; q < kSOwn; ++q) {
      float v[kSChunk];
#pragma unroll
      for (int k = 0; k < kSChunk; ++k) v[k] = 0.f;
#pragma unroll
      for (int j = 0; j < kSChunkPoints; ++j) {
        const int n = q * kSChunkPoints + j;
        if (n >= kSN) break;
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
        v[2 * j] = px;
        v[2 * j + 1] = py;
      }
      f.v[q] = warp_sums(v, lane) + ((lane & 1) ? w.b2y : w.b2x);
    }
    return f;
  }

  // This lane's real components of y into the shared vector `to`.
  __device__ __forceinline__ void put(float* to, const float* y) const {
#pragma unroll
    for (int q = 0; q < kSOwn; ++q)
      if (32 * q + lane < kSNS) to[32 * q + lane] = y[q];
  }

  // The forward's evaluation: y and f are this lane's components.
  __device__ __forceinline__ void rhs(const float* y, float* f) const {
    static_assert(kFwd, "the reverse sweep evaluates through stage slots");
    put(b->pts, y);
    __syncwarp();
    const SpiralOwn o = eval(b->pts, nullptr);
#pragma unroll
    for (int q = 0; q < kSOwn; ++q) f[q] = o.v[q];
    __syncwarp();      // every lane read the point before the next writes
  }

  // The reverse sweep's evaluations (field_stages.cuh).
  __device__ __forceinline__ const float* keep_point(int slot,
                                                     const float* y) const {
    float* pt = b->pts[slot];
    put(pt, y);
    __syncwarp();
    return pt;
  }

  __device__ __forceinline__ void stage_hidden(int slot,
                                               const float* y) const {
    const float* pt = keep_point(slot, y);
#pragma unroll 4
    for (int n = 0; n < kSN; ++n) {
      const float x = pt[2 * n], yy = pt[2 * n + 1];
      const float u = x * x * x, vv = yy * yy * yy;
#pragma unroll
      for (int k = 0; k < kSU; ++k) b->h[slot][n][k][lane] = act(k, u, vv);
    }
  }

  __device__ __forceinline__ void stage_rhs(int slot, const float* y,
                                            float* f) const {
    const SpiralOwn o = eval(keep_point(slot, y), b->h[slot]);
#pragma unroll
    for (int q = 0; q < kSOwn; ++q) f[q] = o.v[q];
  }

  // ybar = (df/dy)^T cot at the point kept in `slot` (v[q] of component
  // spiral_comp(lane, q)), and the weight cotangents of this lane's units
  // accumulated into g, point after point as spiral_field.cuh adds them.
  BODE_SPIRAL_WIDE_EVAL SpiralOwn vjp(int slot, SpiralUnits& g) const {
    const float* pt = b->pts[slot];
    SpiralOwn ybar;
#pragma unroll
    for (int q = 0; q < kSOwn; ++q) {
      float v[kSChunk];
#pragma unroll
      for (int k = 0; k < kSChunk; ++k) v[k] = 0.f;
#pragma unroll
      for (int j = 0; j < kSChunkPoints; ++j) {
        const int n = q * kSChunkPoints + j;
        if (n >= kSN) break;
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
        v[2 * j] = sx;
        v[2 * j + 1] = sy;
      }
      // d(y^3)/dy = 3 y^2, at this lane's component
      const float yi = pt[spiral_comp(lane, q)];
      ybar.v[q] = 3.0f * yi * yi * warp_sums(v, lane);
    }
    return ybar;
  }

  __device__ __forceinline__ void stage_vjp(int slot, const float*,
                                            const float* cot, float* ybar,
                                            SpiralUnits& g) const {
    put(b->cot, cot);
    __syncwarp();
    const SpiralOwn o = vjp(slot, g);
#pragma unroll
    for (int q = 0; q < kSOwn; ++q) ybar[q] = o.v[q];
    __syncwarp();     // cot and the point read before the next writes
  }
};

// What the two kernels share: one warp and one chain a block, lane l
// carrying components spiral_comp(l, q), lane 0 the chain's leader.
template <int kSlots>
struct SpiralWideChain {
  static constexpr int kNS = kSNS;
  static constexpr int kOwn = kSOwn;
  static constexpr int kChains = 1;
  static constexpr int kThreads = 32;
  static constexpr bool kDynamicSmem = true;
  struct Args {
    const float *w1, *b1, *w2, *b2;
  };
  struct Smem {
    typename SpiralWideField<kSlots>::Buf warp;
  };

  SpiralWideField<kSlots> f;

  static __device__ int chain() { return blockIdx.x; }
  static __device__ bool leader() { return threadIdx.x == 0; }
  static __device__ int comp(int q) { return spiral_comp(threadIdx.x, q); }
  static __device__ bool owner() { return threadIdx.x < kSNS; }
  static __device__ bool owns(int q) {
    return 32 * q + static_cast<int>(threadIdx.x) < kSNS;
  }

  __device__ void load_weights(const Args& a, Smem& sm, int C, int c) {
    f.lane = threadIdx.x;
    f.b = &sm.warp;
    spiral_zero(f.w);
    if (c >= C) return;
    spiral_load(f.w, a.w1, a.b1, a.w2, a.b2, c, f.lane);
  }
};

// The forward (K2, with and without records).
struct SpiralDopri5Fwd : SpiralWideChain<0> {
  static __device__ SpiralDopri5Fwd load(const Args& a, Smem& sm, int C,
                                         int c) {
    SpiralDopri5Fwd s;
    s.load_weights(a, sm, C, c);
    return s;
  }

  // The error norm's sums: component i's ratio from lane i % 32 (its
  // i / 32-th), added as the per-chain loop adds them (even i into sx, odd
  // into sy, ascending).
  __device__ __forceinline__ void norm_sums(const float* r, float& sx,
                                            float& sy) const {
#pragma unroll
    for (int i = 0; i < kSNS; ++i) {
      const float ri = __shfl_sync(kFull, r[i / 32], i % 32);
      if (i % 2 == 0) sx += ri * ri; else sy += ri * ri;
    }
  }

  __device__ void rhs(const float* y, float* out) const { f.rhs(y, out); }
};

// The backward (K3): the 7 stage points of a step in slots 0 (y0) to 6
// (u[5]).
struct SpiralDopri5 : SpiralWideChain<7> {
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
    spiral_store(acc, g.w1, g.b1, g.w2, g.b2, c, threadIdx.x);
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
