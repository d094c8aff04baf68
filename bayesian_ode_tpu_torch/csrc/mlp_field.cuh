// The MLP field 2 -> H -> H -> 2 with ELU activations, as a functor for
// the rk4 templates of rk4_common.cuh and (MLPDopri5Fwd and MLPDopri5
// below) the fused adaptive kernels of dopri5_kernels.cuh:
//
//   f(x) = W3^T elu(W2^T elu(W1^T x + b1) + b2) + b3
//
// The design below takes H <= 32 and N <= 16; past either limit the
// kernels are built on mlp_wide_field.cuh instead (BODE_MLP_WIDE), up to
// H = 128 at N <= 16 and H = 64 at N <= 32.
//
// One warp per chain: lane j holds hidden unit j of both hidden layers,
// that is w1[:, j], b1[j], b2[j] and w3[j, :] in registers (b3 on every
// lane), and the cotangents of those and of column j of W2 in the
// backward.  Where W2 (1,024 of a chain's 1,218 weights at H=32) lives
// depends on the kernel.  The forwards (K6, MLP K2: MLPField<0>) keep
// column j in lane j's 32 registers (w.w2c), which fit beside the one
// state component a lane carries.  The reverse sweeps (K7, MLP K3) keep
// it once per warp in shared memory, rows padded to a conflict-free
// stride: lane j reads column j for the forward product and row j for the
// VJP's transposed product.  In registers it would cost 32 a lane, and
// the sweeps would not fit 128 registers, 16 warps an SM.  Lanes j >= H
// hold zero weights and contribute nothing.
//
// What bounds the field on an H100 is the MIO pipe (shuffles and shared
// memory instructions, about one warp instruction a clock per SM) ahead of
// the FP32 FMAs, so the design spends as few of those as it can at the N
// points of an evaluation:
//   - h1 reaches the other lanes through a per-warp copy in shared memory:
//     lane j writes h1_j of the N points, and each lane forms
//     a2_j = sum_i W2[i][j] h1_i from 16-byte broadcast reads, in the order
//     i = 0..H-1, W2[i][j] from registers (the forwards) or from the kept
//     rows (the sweeps: one load serving all N points).  The VJP's outer
//     product g.W2[i][j] += h1_i a2bar_j reads the same copy.  (At H=32 and
//     N=5 a hidden pass is 40 broadcast loads, and in the sweeps 32 column
//     loads, where shuffles took 160.)
//   - The VJP's transposed product h1bar_i = sum_j W2[i][j] a2bar_j: lane i
//     sums its row of W2 against a2bar broadcast from shared memory, in the
//     order j = 0..H-1 (in place of 32 stores and 32 loads a point through
//     a transposing scratch).
//   - The 2N output sums (f, or ybar in the VJP) are one 16-wide
//     reduce-scatter (warp_sum16: 16 shuffles in place of 10 butterflies
//     of 5), which leaves component i on lane i; past N = 8 one 32-wide
//     one (warp_sum32, 31 shuffles).  N <= 16: a state component a lane.
//   - The reverse sweeps keep each stage point's activations (h1 of all
//     units and a2) from the pass that recomputes the stages, in a stage
//     slot (field_stages.cuh), so a VJP computes no second hidden layer.
//     a1 is recomputed from the kept point (2 FMAs).
// Every kernel carries the chain's state distributed over the warp: lane
// i < 2N holds component i of every per-step array (stage points, stage
// derivatives, cotangents), gathered through the warp's shared copy for an
// evaluation, which leaves f_i on lane i; lanes >= 2N compute on values
// nobody reads and write nothing.  MLP K2 takes its step decisions from
// the error norm gathered from lanes 0..2N-1 (MLPDopri5Fwd::norm_sums),
// the same bits on every lane.  A __syncwarp() separates every shared
// write from another lane's read of it, and every read from the next
// overwrite: the lanes of a warp do not run in lockstep.
//
// ELU is expf(a) - 1 with derivative a > 0 ? 1 : expf(a), as the TPU
// kernel computes it (the forwards select between the arms without a
// branch: elu_select).  Full float32 FMAs on the CUDA cores throughout.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "warp.cuh"

#ifndef MLP_N
#error "MLP_N (trajectory points per chain) must be defined at build time"
#endif
#ifndef MLP_H
#error "MLP_H (hidden width) must be defined at build time"
#endif

namespace bode {

constexpr int kMN = MLP_N;
constexpr int kMNS = 2 * MLP_N;            // state components per chain
constexpr int kH = MLP_H;
constexpr int kH4 = (kH + 3) / 4 * 4;      // H in whole float4s
constexpr int kVec = (kMNS + 3) / 4 * 4;

__device__ __forceinline__ float elu(float a) {
  return a > 0.f ? a : expf(a) - 1.0f;
}
// The same ELU with both arms computed and one selected: nvcc compiles
// elu's ternary into a branch around the expf at each point, which keeps
// the N points' expf from overlapping; a PTX selp it cannot turn back into
// a branch.  The same bits; the forwards take it (on an H100, with no
// launch bounds, K6 7-11% and MLP K2 17-21% faster than with elu).
__device__ __forceinline__ float elu_select(float a) {
  const float e = expf(a) - 1.0f;
  float r;
  asm("{\n\t.reg .pred p;\n\tsetp.gt.f32 p, %1, 0f00000000;\n\t"
      "selp.f32 %0, %1, %2, p;\n\t}" : "=f"(r) : "f"(a), "f"(e));
  return r;
}
__device__ __forceinline__ float elu_deriv(float a) {
  return a > 0.f ? 1.0f : expf(a);
}

}  // namespace bode

// The design of this file takes H <= 32 and N <= 16; wider shapes take
// mlp_wide_field.cuh's, and the kernels' sources pick theirs by this.
#define BODE_MLP_WIDE (MLP_H > 32 || MLP_N > 16)

#if BODE_MLP_WIDE
#include "mlp_wide_field.cuh"
#else
namespace bode {

constexpr int kFwdWarps = 4;               // chains per block of K6, MLP K2
// K6's blocks an SM for __launch_bounds__: 96 registers, no spills (left
// to itself ptxas picks 72 and spills two values)
constexpr int kFwdMinBlocks = 5;
// a W2 row's stride: an odd number of float4s, so that 8 lanes reading
// their rows by float4 hit 8 different groups of 4 banks
constexpr int kRow = (kH4 / 4) % 2 ? kH4 : kH4 + 4;
static_assert(kH >= 1 && kH <= 32, "one hidden unit per lane: H <= 32");
static_assert(kMNS <= 32, "one state component a lane: N <= 16");
constexpr int kSums = kSumWidth<kMNS>;     // warp_sum16, or 32 past N = 8

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

// A warp's shared memory: W2, kSlots kept points with their activations,
// and the VJP's gathered cotangent.
template <int kSlots>
struct __align__(16) MLPBuf {
  float h1[kSlots][kMN][32];   // h1 of unit j at [j], at each kept point
  float a2[kSlots][kMN][32];   // a2, read back by its own lane; the VJP
                               // overwrites it with a2bar for the others
  float w2r[kH][kRow];         // W2, by rows
  float pts[kSlots][kVec];     // the kept points, gathered from their lanes
  float cot[kVec];             // the VJP's cotangent, gathered likewise
};

// A forward's warp buffer: the gathered point and its h1 (W2 stays in
// registers), 688 B at N=5.
struct __align__(16) MLPFwdBuf {
  float h1[kMN][32];
  float pts[kVec];
};

// K7's chains a block: 4 (9,968 B a warp at N=5, H=32), or 2 where four
// warps' buffers would pass the 48 KB of static shared memory (from N = 8
// on at H = 32: 13,120 B a warp at N=8, 21,632 B at N=16).  The register
// target stays 16 warps an SM (kBwdMinBlocks).
constexpr int kWarpsPerBlock = warps_fitting(4, sizeof(MLPBuf<4>));
constexpr int kMLPBlock = 32 * kWarpsPerBlock;
constexpr int kBwdMinBlocks = 16 / kWarpsPerBlock;

// kSlots > 0: the reverse sweeps' field, W2 and kSlots stage slots in
// MLPBuf<kSlots> (call keep_w2 once); kSlots = 0: the forwards' field, W2
// in registers and an MLPFwdBuf.
template <int kSlots>
struct MLPField {
  static constexpr bool kFwd = kSlots == 0;
  static constexpr int kStageSlots = kSlots;
  using Buf = std::conditional_t<kFwd, MLPFwdBuf, MLPBuf<kSlots>>;
  MLPUnit w;
  Buf* b;              // this warp's buffer
  int lane;

  // Keep W2 in the warp's buffer, once per chain: the products read it
  // from there (by columns in layer2, by rows in the VJP), so w.w2c is
  // dead afterwards and its 32 registers are free.
  __device__ __forceinline__ void keep_w2() const {
    if (lane < kH) {
#pragma unroll
      for (int i = 0; i < kH; ++i) b->w2r[i][lane] = w.w2c[i];
    }
    __syncwarp();
  }

  static __device__ __forceinline__ float act(float a) {
    if constexpr (kFwd) return elu_select(a); else return elu(a);
  }

  __device__ __forceinline__ float pre1(float x, float y) const {
    return w.w1x * x + w.w1y * y + w.b1;
  }

  // a2 of this lane's unit at the N points from h1 (all units, in shared
  // memory), summed in the order i = 0..H-1; W2's column `lane` is read
  // from registers (the forwards) or from the kept rows (one
  // conflict-free load per i for all N points).
  __device__ __forceinline__ void layer2(const float (*h1)[32],
                                         float* a2) const {
    float s[kMN];
#pragma unroll
    for (int n = 0; n < kMN; ++n) s[n] = 0.f;
#pragma unroll
    for (int i = 0; i < kH; i += 4) {
      float c[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if constexpr (kFwd)
          c[k] = i + k < kH ? w.w2c[i + k] : 0.f;
        else
          c[k] = (i + k < kH && lane < kH) ? b->w2r[i + k][lane] : 0.f;
      }
#pragma unroll
      for (int n = 0; n < kMN; ++n) {
        const float4 v = *reinterpret_cast<const float4*>(&h1[n][i]);
        s[n] += c[0] * v.x;
        if (i + 1 < kH) s[n] += c[1] * v.y;
        if (i + 2 < kH) s[n] += c[2] * v.z;
        if (i + 3 < kH) s[n] += c[3] * v.w;
      }
    }
#pragma unroll
    for (int n = 0; n < kMN; ++n) a2[n] = s[n] + w.b2;
  }

  // Both hidden layers at the N points pt[2n], pt[2n + 1]: h1 into h1s
  // (every lane's unit), a2 of this lane's unit returned.
  __device__ __forceinline__ void hidden(const float* pt, float (*h1s)[32],
                                         float* a2) const {
#pragma unroll
    for (int n = 0; n < kMN; ++n)
      h1s[n][lane] = act(pre1(pt[2 * n], pt[2 * n + 1]));
    __syncwarp();
    layer2(h1s, a2);
  }

  // f from the N points' a2: lane i (i < 2N) returns f_i.
  __device__ __forceinline__ float out_sums(const float* a2) const {
    float v[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) v[k] = 0.f;
#pragma unroll
    for (int n = 0; n < kMN; ++n) {
      const float h2 = act(a2[n]);
      v[2 * n] = w.w3x * h2;
      v[2 * n + 1] = w.w3y * h2;
    }
    return warp_sums(v, lane) + ((lane & 1) ? w.b3y : w.b3x);
  }

  // The forwards' evaluation (MLPField<0>): y[0] is component `lane` of
  // the point, f[0] returns f_lane.  The __syncwarp() after the point's
  // write also orders the last evaluation's reads of pts and h1 before
  // this one's writes.
  __device__ __forceinline__ void rhs(const float* y, float* f) const {
    static_assert(kFwd, "the reverse sweeps evaluate through stage slots");
    if (lane < kMNS) b->pts[lane] = y[0];
    __syncwarp();
    float a2[kMN];
    hidden(b->pts, b->h1, a2);
    f[0] = out_sums(a2);
  }

  // The reverse sweeps' evaluations (field_stages.cuh).  y, f, cot and ybar
  // are this lane's component: y[0] is component `lane` of the point.
  __device__ __forceinline__ void keep_point(int slot, const float* y,
                                             float* a2) const {
    float* pt = b->pts[slot];
    if (lane < kMNS) pt[lane] = y[0];
    __syncwarp();
    hidden(pt, b->h1[slot], a2);
#pragma unroll
    for (int n = 0; n < kMN; ++n) b->a2[slot][n][lane] = a2[n];
  }

  __device__ __forceinline__ void stage_hidden(int slot,
                                               const float* y) const {
    float a2[kMN];
    keep_point(slot, y, a2);
  }

  __device__ __forceinline__ void stage_rhs(int slot, const float* y,
                                            float* f) const {
    float a2[kMN];
    keep_point(slot, y, a2);
    f[0] = out_sums(a2);
  }

  // ybar = (df/dy)^T cot at the point kept in `slot`, and the weight
  // cotangents of this lane's unit accumulated into g.
  __device__ __forceinline__ void stage_vjp(int slot, const float*,
                                            const float* cot, float* ybar,
                                            MLPUnit& g) const {
    if (lane < kMNS) b->cot[lane] = cot[0];
    __syncwarp();
    const float* pt = b->pts[slot];
#pragma unroll
    for (int n = 0; n < kMN; ++n) {
      const float cx = b->cot[2 * n], cy = b->cot[2 * n + 1];
      const float a2 = b->a2[slot][n][lane];
      const float h2 = elu(a2);
      g.b3x += cx;
      g.b3y += cy;
      g.w3x += h2 * cx;
      g.w3y += h2 * cy;
      const float h2b = w.w3x * cx + w.w3y * cy;
      const float a2b = h2b * elu_deriv(a2);
      g.b2 += a2b;
      b->a2[slot][n][lane] = a2b;     // this lane has read its a2
    }
    __syncwarp();
    // g.W2[i][lane] += h1_i a2bar, point after point (a loop, not
    // unrolled: the 40 cotangents stay in registers, and unrolled the
    // compiler would hoist every point's h1 loads past the register cap)
#pragma unroll 1
    for (int n = 0; n < kMN; ++n) {
      const float a = b->a2[slot][n][lane];
#pragma unroll
      for (int i = 0; i < kH; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(&b->h1[slot][n][i]);
        g.w2c[i] += v.x * a;
        if (i + 1 < kH) g.w2c[i + 1] += v.y * a;
        if (i + 2 < kH) g.w2c[i + 2] += v.z * a;
        if (i + 3 < kH) g.w2c[i + 3] += v.w * a;
      }
    }
    // h1bar_i = sum_j W2[i][j] a2bar_j on lane i, j = 0..H-1
    float hb[kMN];
#pragma unroll
    for (int n = 0; n < kMN; ++n) hb[n] = 0.f;
    if (lane < kH) {
#pragma unroll
      for (int j = 0; j < kH; j += 4) {
        const float4 r = *reinterpret_cast<const float4*>(&b->w2r[lane][j]);
#pragma unroll
        for (int n = 0; n < kMN; ++n) {
          const float4 a =
              *reinterpret_cast<const float4*>(&b->a2[slot][n][j]);
          hb[n] += r.x * a.x;
          if (j + 1 < kH) hb[n] += r.y * a.y;
          if (j + 2 < kH) hb[n] += r.z * a.z;
          if (j + 3 < kH) hb[n] += r.w * a.w;
        }
      }
    }
    float v[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) v[k] = 0.f;
#pragma unroll
    for (int n = 0; n < kMN; ++n) {
      const float x = pt[2 * n], yy = pt[2 * n + 1];
      const float a1b = hb[n] * elu_deriv(pre1(x, yy));
      g.b1 += a1b;
      g.w1x += x * a1b;
      g.w1y += yy * a1b;
      v[2 * n] = w.w1x * a1b;
      v[2 * n + 1] = w.w1y * a1b;
    }
    ybar[0] = warp_sums(v, lane);
    __syncwarp();     // cot and a2bar read before the next VJP writes them
  }
};

// What the MLP field's two adaptive kernels share (dopri5_kernels.cuh):
// one warp per chain, kC chains a block, lane i < 2N carrying component i
// (lanes past it mirror the last), lane 0 the chain's leader; the weights
// in the layer-list layout of mlp_load.
template <int kC, int kSlots>
struct MLPWarpChains {
  static constexpr int kNS = kMNS;
  static constexpr int kChains = kC;
  static constexpr int kThreads = 32 * kC;
  static constexpr int kOwn = 1;
  struct Args {
    const float *w1, *b1, *w2, *b2, *w3, *b3;
  };
  struct Smem {
    typename MLPField<kSlots>::Buf warp[kC];
  };

  MLPField<kSlots> f;

  static __device__ int chain() {
    return blockIdx.x * kChains + (threadIdx.x >> 5);
  }
  static __device__ bool leader() { return (threadIdx.x & 31) == 0; }
  static __device__ int comp(int) {
    const int lane = threadIdx.x & 31;
    return lane < kMNS ? lane : kMNS - 1;
  }
  static __device__ bool owner() { return (threadIdx.x & 31) < kMNS; }

  // this lane's weights (zeros past the last chain) and its warp's buffer
  __device__ void load_weights(const Args& a, Smem& sm, int C, int c) {
    f.lane = threadIdx.x & 31;
    f.b = &sm.warp[threadIdx.x >> 5];
    if (c < C)
      mlp_load(f.w, c, f.lane, a.w1, a.b1, a.w2, a.b2, a.w3, a.b3);
    else
      mlp_zero(f.w);
  }
};

// The forward (K2, with and without records): W2 in registers, a warp's
// buffer 688 B at N=5.  Lanes 0..2N-1 write the dense output and records,
// lane 0 t0, dt and the counters.
struct MLPDopri5Fwd : MLPWarpChains<kFwdWarps, 0> {
  // at most 128 registers, 16 warps an SM: no spills (left to itself, or
  // given 112 or fewer, ptxas picks 96 and spills 12-24 B)
  static constexpr int kMinBlocks = 4;
  static __device__ MLPDopri5Fwd load(const Args& a, Smem& sm, int C,
                                      int c) {
    MLPDopri5Fwd m;
    m.load_weights(a, sm, C, c);
    return m;
  }

  // The error norm's sums (field_stages.cuh): component i's ratio from
  // lane i, added as the per-chain loop adds them (dopri5_common.cuh,
  // step_decision: even i into sx, odd into sy, ascending), so every lane
  // takes the same step decision.  The warp is one chain and stays in its
  // loop as a whole, so every lane takes part.
  __device__ __forceinline__ void norm_sums(const float* r, float& sx,
                                            float& sy) const {
#pragma unroll
    for (int i = 0; i < kMNS; ++i) {
      const float ri = __shfl_sync(kFull, r[0], i);
      if (i % 2 == 0) sx += ri * ri; else sy += ri * ri;
    }
  }

  __device__ void rhs(const float* y, float* out) const { f.rhs(y, out); }
};

// The backward (K3): the 7 stage points of a step in slots 0 (y0) to 6
// (u[5]), W2 in shared memory.  Two chains a block: a warp's buffer is
// 13,952 B at N=5, H=32, so four would pass the 48 KB of static shared
// memory a block may have; one from N = 11 on at H = 32 (34,304 B at
// N=16).
struct MLPDopri5 : MLPWarpChains<warps_fitting(2, sizeof(MLPBuf<7>)), 7> {
  static constexpr int kStageSlots = 7;
  struct Grads {
    float *w1, *b1, *w2, *b2, *w3, *b3;
  };
  struct AccSmem {};
  using Acc = MLPUnit;

  static __device__ MLPDopri5 load(const Args& a, Smem& sm, int C, int c) {
    MLPDopri5 m;
    m.load_weights(a, sm, C, c);
    m.f.keep_w2();
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
#endif  // BODE_MLP_WIDE
