// The MLP field past one warp's units or lanes: H > 32 (to H = 128 at
// N <= 16) or N > 16 (to N = 32 at H <= 64).  mlp_field.cuh includes it
// for those shapes in place of its own design, which the instances at
// H <= 32 and N <= 16 keep.
//
// Still one warp per chain, now one chain a block (32 threads): a chain's
// buffers take tens of KB (70,192 B in the forwards at N=5, H=128), so
// blocks of one warp let the SM hold as many chains as its shared memory
// fits.  Every buffer lives in dynamic shared memory (kDynamicSmem,
// field_stages.cuh), a block's limit raised past 48 KB once per kernel.
//   - Hidden units: kMU = ceil(H/32) a lane, lane l holding units l,
//     l + 32, ... (as spiral_field.cuh's kSU); units past H hold zero
//     weights and add nothing.
//   - W2 by rows in the warp's buffer in every kernel (at H=128 it is 64
//     KB a chain; a lane's columns would take 4 x 128 registers).  a2 of
//     unit u sums W2[i][u] h1_i over i = 0..H-1 reading row i (consecutive
//     lanes read consecutive words), h1_i broadcast by 16-byte loads from
//     the warp's h1 copy; the VJP's transposed product h1bar_u = sum_j
//     W2[u][j] a2bar_j reads row u by float4s (rows padded to an odd
//     number of float4s, as mlp_field.cuh's kRow).  Rows and columns past
//     H hold zeros, so the loops run over whole float4s unguarded.
//   - The reverse sweeps accumulate W2bar in the block's AccSmem, each lane
//     its own columns (no other lane touches them), and keep each stage
//     point's a2 (not h1) in a stage slot: the VJP recomputes h1 of its
//     units from the kept point into the warp's one h1 copy, the same
//     bits as the stage pass (elu of the same pre-activation).
//   - State components: kMOwn = 1 to N = 16 (lane i carries component i,
//     as mlp_field.cuh), 2 past it (lane n carries point n: x_n and y_n,
//     lanes past N mirror point N - 1 and write nothing).  The 2N output
//     sums are one warp_sums (kMOwn = 1) or two warp_sum32, one of the x
//     sums and one of the y sums (kMOwn = 2), which leave f_x and f_y of
//     point n on lane n.  MLP K2's norm_sums gathers the 2N ratios in the
//     per-chain order either way.
// Each unit's sums keep the order of mlp_field.cuh (i, j ascending; W2bar
// point after point); the output sums add a lane's units first, then the
// lanes.  A __syncwarp() separates every shared write from another lane's
// read of it and every read from the next overwrite.
//   - Past N = 16 the field's evaluations (rhs, stage_rhs, stage_hidden,
//     stage_vjp) are compiled once each and called, not inlined into every
//     stage of a step: the sweeps' 14 inlined copies of their 32-point
//     loops took nvcc 90 s for MLP K3 at N = 32, H = 64, past every other
//     library's build.  The stage buffers they read and write then live in
//     local memory.
#pragma once

#if MLP_N > 16
#define BODE_MLP_WIDE_EVAL __device__ __noinline__
#else
#define BODE_MLP_WIDE_EVAL __device__ __forceinline__
#endif

namespace bode {

constexpr int kMU = (kH + 31) / 32;          // hidden units a lane
constexpr int kHU = 32 * kMU;                // an h1 row: unit u at [u]
constexpr int kMOwn = kMNS <= 32 ? 1 : 2;    // state components a lane
// a W2 row's stride: kHU floats and 4 more, an odd number of float4s, so
// that 8 lanes reading their rows by float4 hit 8 different groups of 4
// banks
constexpr int kWRow = kHU + 4;
constexpr int kSums = kSumWidth<kMOwn == 1 ? kMNS : 32>;
static_assert(kMN <= 32 && kH <= (kMN <= 16 ? 128 : 64),
              "the wide MLP field takes H <= 128 at N <= 16, H <= 64 at "
              "N <= 32");

// This lane's q-th state component (lanes past the chain's mirror the
// last), and whether the lane writes its components out.
__device__ __forceinline__ int mlp_comp(int lane, int q) {
  if constexpr (kMOwn == 1)
    return lane < kMNS ? lane : kMNS - 1;
  else
    return 2 * (lane < kMN ? lane : kMN - 1) + q;
}
__device__ __forceinline__ bool mlp_owner(int lane) {
  return lane < kMNS / kMOwn;
}

// This lane's units of one chain's weights (or of their cotangents), all
// but W2.
struct MLPWideUnits {
  float w1x[kMU], w1y[kMU], b1[kMU], b2[kMU], w3x[kMU], w3y[kMU];
  float b3x, b3y;
};

__device__ __forceinline__ void mlp_wide_zero(MLPWideUnits& u) {
#pragma unroll
  for (int k = 0; k < kMU; ++k)
    u.w1x[k] = u.w1y[k] = u.b1[k] = u.b2[k] = u.w3x[k] = u.w3y[k] = 0.f;
  u.b3x = u.b3y = 0.f;
}

// Chain c's weights in the layer-list layout of mlp_load (mlp_field.cuh):
// this lane's units into u (zeros past H), W2 by rows into w2r (zeros
// past H), then a __syncwarp() before any lane reads the rows.
__device__ __forceinline__ void mlp_wide_load(
    MLPWideUnits& u, float (*w2r)[kWRow], int c, int lane,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ w3, const float* __restrict__ b3) {
  const size_t cc = static_cast<size_t>(c);
#pragma unroll
  for (int k = 0; k < kMU; ++k) {
    const int un = lane + 32 * k;
    const bool in = un < kH;
    u.w1x[k] = in ? w1[cc * 2 * kH + un] : 0.f;
    u.w1y[k] = in ? w1[cc * 2 * kH + kH + un] : 0.f;
    u.b1[k] = in ? b1[cc * kH + un] : 0.f;
    u.b2[k] = in ? b2[cc * kH + un] : 0.f;
    u.w3x[k] = in ? w3[(cc * kH + un) * 2] : 0.f;
    u.w3y[k] = in ? w3[(cc * kH + un) * 2 + 1] : 0.f;
  }
  u.b3x = b3[cc * 2];
  u.b3y = b3[cc * 2 + 1];
#pragma unroll 1
  for (int i = 0; i < kH4; ++i) {
#pragma unroll
    for (int k = 0; k < kMU; ++k) {
      const int un = lane + 32 * k;
      w2r[i][un] = i < kH && un < kH ? w2[(cc * kH + i) * kH + un] : 0.f;
    }
  }
  __syncwarp();
}

// A forward's warp buffer: W2's rows, the h1 copy and the gathered point.
struct __align__(16) MLPWideFwdBuf {
  float w2r[kH4][kWRow];
  float h1[kMN][kHU];
  float pts[kVec];
};

// A reverse sweep's warp buffer: W2's rows, the h1 copy, kSlots kept
// points with their a2 (the VJP overwrites a slot's a2 with a2bar for the
// transposed product), and the VJP's gathered cotangent.
template <int kSlots>
struct __align__(16) MLPWideBuf {
  float w2r[kH4][kWRow];
  float h1[kMN][kHU];
  float a2[kSlots][kMN][kHU];
  float pts[kSlots][kVec];
  float cot[kVec];
};

// W2bar of the block's chain, each lane's columns its own (AccSmem).
struct MLPWideW2bar {
  float w2b[kH4][kHU];
};

// A lane's cotangents: its units' in registers, W2bar's in shared memory.
struct MLPWideAcc {
  MLPWideUnits u;
  float (*w2b)[kHU];
};

__device__ __forceinline__ MLPWideAcc mlp_wide_acc(MLPWideW2bar& s,
                                                   int lane) {
  MLPWideAcc g;
  mlp_wide_zero(g.u);
  g.w2b = s.w2b;
#pragma unroll 1
  for (int i = 0; i < kH4; ++i) {
#pragma unroll
    for (int k = 0; k < kMU; ++k) s.w2b[i][lane + 32 * k] = 0.f;
  }
  return g;
}

// Chain c's weight cotangents, in the layout of mlp_wide_load.
__device__ __forceinline__ void mlp_wide_store(
    const MLPWideAcc& g, int c, int lane, float* __restrict__ w1,
    float* __restrict__ b1, float* __restrict__ w2, float* __restrict__ b2,
    float* __restrict__ w3, float* __restrict__ b3) {
  const size_t cc = static_cast<size_t>(c);
#pragma unroll
  for (int k = 0; k < kMU; ++k) {
    const int un = lane + 32 * k;
    if (un >= kH) continue;
    w1[cc * 2 * kH + un] = g.u.w1x[k];
    w1[cc * 2 * kH + kH + un] = g.u.w1y[k];
    b1[cc * kH + un] = g.u.b1[k];
    b2[cc * kH + un] = g.u.b2[k];
    w3[(cc * kH + un) * 2] = g.u.w3x[k];
    w3[(cc * kH + un) * 2 + 1] = g.u.w3y[k];
#pragma unroll 1
    for (int i = 0; i < kH; ++i) w2[(cc * kH + i) * kH + un] = g.w2b[i][un];
  }
  if (lane == 0) {
    b3[cc * 2] = g.u.b3x;
    b3[cc * 2 + 1] = g.u.b3y;
  }
}

// kSlots > 0: the reverse sweeps' field, kSlots stage slots in
// MLPWideBuf<kSlots>; kSlots = 0: the forwards', an MLPWideFwdBuf.
template <int kSlots>
struct MLPWide {
  static constexpr bool kFwd = kSlots == 0;
  static constexpr int kStageSlots = kSlots;
  using Buf = std::conditional_t<kFwd, MLPWideFwdBuf, MLPWideBuf<kSlots>>;
  MLPWideUnits w;
  Buf* b;              // this warp's buffer
  int lane;

  static __device__ __forceinline__ float act(float a) {
    if constexpr (kFwd) return elu_select(a); else return elu(a);
  }

  __device__ __forceinline__ float pre1(int k, float x, float y) const {
    return w.w1x[k] * x + w.w1y[k] * y + w.b1[k];
  }

  // This lane's components of the point y into pt, for every lane to read.
  __device__ __forceinline__ void gather(float* pt, const float* y) const {
    if constexpr (kMOwn == 1) {
      if (lane < kMNS) pt[lane] = y[0];
    } else if (lane < kMN) {
      pt[2 * lane] = y[0];
      pt[2 * lane + 1] = y[1];
    }
    __syncwarp();
  }

  // a2 of this lane's units at the N points from the h1 copy, summed over
  // the rows i = 0..H-1 (and the zero rows to a whole float4).
  __device__ __forceinline__ void layer2(float (&a2)[kMU][kMN]) const {
    float s[kMU][kMN];
#pragma unroll
    for (int k = 0; k < kMU; ++k)
#pragma unroll
      for (int n = 0; n < kMN; ++n) s[k][n] = 0.f;
#pragma unroll 1
    for (int i = 0; i < kH4; i += 4) {
      float c[kMU][4];
#pragma unroll
      for (int k = 0; k < kMU; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) c[k][j] = b->w2r[i + j][lane + 32 * k];
#pragma unroll
      for (int n = 0; n < kMN; ++n) {
        const float4 v = *reinterpret_cast<const float4*>(&b->h1[n][i]);
#pragma unroll
        for (int k = 0; k < kMU; ++k) {
          s[k][n] += c[k][0] * v.x;
          s[k][n] += c[k][1] * v.y;
          s[k][n] += c[k][2] * v.z;
          s[k][n] += c[k][3] * v.w;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kMU; ++k)
#pragma unroll
      for (int n = 0; n < kMN; ++n) a2[k][n] = s[k][n] + w.b2[k];
  }

  // Both hidden layers at the N points pt[2n], pt[2n + 1]: h1 of this
  // lane's units into the h1 copy, a2 of its units returned.  The caller's
  // gather synced the warp after every lane's last read of the copy.
  __device__ __forceinline__ void hidden(const float* pt,
                                         float (&a2)[kMU][kMN]) const {
#pragma unroll
    for (int n = 0; n < kMN; ++n) {
      const float x = pt[2 * n], y = pt[2 * n + 1];
#pragma unroll
      for (int k = 0; k < kMU; ++k)
        b->h1[n][lane + 32 * k] = act(pre1(k, x, y));
    }
    __syncwarp();
    layer2(a2);
  }

  // The 2N sums of v (this lane's share of component i at v[i]): component
  // mlp_comp(lane, q) in out[q].
  __device__ __forceinline__ void sums(const float (&vx)[32],
                                       const float (&vy)[32],
                                       float* out) const {
    if constexpr (kMOwn == 1) {
      float v[kSums];
#pragma unroll
      for (int k = 0; k < kSums; ++k) v[k] = 0.f;
#pragma unroll
      for (int n = 0; n < kMN; ++n) {
        v[2 * n] = vx[n];
        v[2 * n + 1] = vy[n];
      }
      out[0] = warp_sums(v, lane);
    } else {
      out[0] = warp_sum32(vx, lane);
      out[1] = warp_sum32(vy, lane);
    }
  }

  // f from the N points' a2: component mlp_comp(lane, q) in f[q].
  __device__ __forceinline__ void out_sums(const float (&a2)[kMU][kMN],
                                           float* f) const {
    float vx[32], vy[32];
#pragma unroll
    for (int n = 0; n < 32; ++n) vx[n] = vy[n] = 0.f;
#pragma unroll
    for (int n = 0; n < kMN; ++n) {
#pragma unroll
      for (int k = 0; k < kMU; ++k) {
        const float h2 = act(a2[k][n]);
        vx[n] += w.w3x[k] * h2;
        vy[n] += w.w3y[k] * h2;
      }
    }
    sums(vx, vy, f);
#pragma unroll
    for (int q = 0; q < kMOwn; ++q)
      f[q] += (mlp_comp(lane, q) & 1) ? w.b3y : w.b3x;
  }

  // The forwards' evaluation (MLPWide<0>): y and f hold this lane's
  // components.  The gather's __syncwarp() also orders the last
  // evaluation's reads of pts and h1 before this one's writes.
  BODE_MLP_WIDE_EVAL void rhs(const float* y, float* f) const {
    static_assert(kFwd, "the reverse sweeps evaluate through stage slots");
    gather(b->pts, y);
    float a2[kMU][kMN];
    hidden(b->pts, a2);
    out_sums(a2, f);
  }

  // The reverse sweeps' evaluations (field_stages.cuh).
  __device__ __forceinline__ void keep_point(int slot, const float* y,
                                             float (&a2)[kMU][kMN]) const {
    float* pt = b->pts[slot];
    gather(pt, y);
    hidden(pt, a2);
#pragma unroll
    for (int n = 0; n < kMN; ++n)
#pragma unroll
      for (int k = 0; k < kMU; ++k) b->a2[slot][n][lane + 32 * k] = a2[k][n];
  }

  BODE_MLP_WIDE_EVAL void stage_hidden(int slot, const float* y) const {
    float a2[kMU][kMN];
    keep_point(slot, y, a2);
  }

  BODE_MLP_WIDE_EVAL void stage_rhs(int slot, const float* y,
                                    float* f) const {
    float a2[kMU][kMN];
    keep_point(slot, y, a2);
    out_sums(a2, f);
  }

  // ybar = (df/dy)^T cot at the point kept in `slot`, and the weight
  // cotangents of this lane's units accumulated into g.
  BODE_MLP_WIDE_EVAL void stage_vjp(int slot, const float*,
                                    const float* cot, float* ybar,
                                    MLPWideAcc& g) const {
    gather(b->cot, cot);
    const float* pt = b->pts[slot];
    // a2bar of this lane's units, kept in registers for W2bar and in the
    // slot for the transposed product; h1 recomputed into the copy
    float a2b[kMU][kMN];
#pragma unroll
    for (int n = 0; n < kMN; ++n) {
      const float cx = b->cot[2 * n], cy = b->cot[2 * n + 1];
      const float x = pt[2 * n], yy = pt[2 * n + 1];
      g.u.b3x += cx;
      g.u.b3y += cy;
#pragma unroll
      for (int k = 0; k < kMU; ++k) {
        const int un = lane + 32 * k;
        const float a2 = b->a2[slot][n][un];
        const float h2 = elu(a2);
        g.u.w3x[k] += h2 * cx;
        g.u.w3y[k] += h2 * cy;
        const float h2b = w.w3x[k] * cx + w.w3y[k] * cy;
        a2b[k][n] = h2b * elu_deriv(a2);
        g.u.b2[k] += a2b[k][n];
        b->a2[slot][n][un] = a2b[k][n];    // this lane has read its a2
        b->h1[n][un] = elu(pre1(k, x, yy));
      }
    }
    __syncwarp();
    // g.W2[i][u] += h1_i a2bar_u, point after point, on this lane's columns
#pragma unroll 1
    for (int i = 0; i < kH4; i += 4) {
      float acc[kMU][4];
#pragma unroll
      for (int k = 0; k < kMU; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[k][j] = g.w2b[i + j][lane + 32 * k];
#pragma unroll
      for (int n = 0; n < kMN; ++n) {
        const float4 v = *reinterpret_cast<const float4*>(&b->h1[n][i]);
#pragma unroll
        for (int k = 0; k < kMU; ++k) {
          acc[k][0] += v.x * a2b[k][n];
          acc[k][1] += v.y * a2b[k][n];
          acc[k][2] += v.z * a2b[k][n];
          acc[k][3] += v.w * a2b[k][n];
        }
      }
#pragma unroll
      for (int k = 0; k < kMU; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) g.w2b[i + j][lane + 32 * k] = acc[k][j];
    }
    // h1bar_u = sum_j W2[u][j] a2bar_j on this lane's units, j = 0..H-1
    float hb[kMU][kMN];
#pragma unroll
    for (int k = 0; k < kMU; ++k)
#pragma unroll
      for (int n = 0; n < kMN; ++n) hb[k][n] = 0.f;
#pragma unroll 1
    for (int j = 0; j < kH4; j += 4) {
      float4 r[kMU];
#pragma unroll
      for (int k = 0; k < kMU; ++k) {
        const int un = lane + 32 * k;
        r[k] = un < kH ? *reinterpret_cast<const float4*>(&b->w2r[un][j])
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int n = 0; n < kMN; ++n) {
        const float4 a = *reinterpret_cast<const float4*>(&b->a2[slot][n][j]);
#pragma unroll
        for (int k = 0; k < kMU; ++k) {
          hb[k][n] += r[k].x * a.x;
          hb[k][n] += r[k].y * a.y;
          hb[k][n] += r[k].z * a.z;
          hb[k][n] += r[k].w * a.w;
        }
      }
    }
    float vx[32], vy[32];
#pragma unroll
    for (int n = 0; n < 32; ++n) vx[n] = vy[n] = 0.f;
#pragma unroll
    for (int n = 0; n < kMN; ++n) {
      const float x = pt[2 * n], yy = pt[2 * n + 1];
#pragma unroll
      for (int k = 0; k < kMU; ++k) {
        const float a1b = hb[k][n] * elu_deriv(pre1(k, x, yy));
        g.u.b1[k] += a1b;
        g.u.w1x[k] += x * a1b;
        g.u.w1y[k] += yy * a1b;
        vx[n] += w.w1x[k] * a1b;
        vy[n] += w.w1y[k] * a1b;
      }
    }
    sums(vx, vy, ybar);
    __syncwarp();     // cot, h1 and a2bar read before the next write
  }
};

// What the wide field's two adaptive kernels share (dopri5_kernels.cuh):
// one warp a chain and a block, the lane's components as mlp_comp says,
// lane 0 the chain's leader; the block's buffers in dynamic shared memory.
template <int kSlots>
struct MLPWideChains {
  static constexpr int kNS = kMNS;
  static constexpr int kChains = 1;
  static constexpr int kThreads = 32;
  static constexpr int kOwn = kMOwn;
  static constexpr bool kDynamicSmem = true;
  struct Args {
    const float *w1, *b1, *w2, *b2, *w3, *b3;
  };
  using Smem = typename MLPWide<kSlots>::Buf;

  MLPWide<kSlots> f;

  static __device__ int chain() { return blockIdx.x; }
  static __device__ bool leader() { return threadIdx.x == 0; }
  static __device__ int comp(int q) { return mlp_comp(threadIdx.x, q); }
  static __device__ bool owner() { return mlp_owner(threadIdx.x); }

  // this lane's weights and W2's rows (zeros past the last chain)
  __device__ void load_weights(const Args& a, Smem& sm, int C, int c) {
    f.lane = threadIdx.x;
    f.b = &sm;
    if (c < C)
      mlp_wide_load(f.w, sm.w2r, c, f.lane, a.w1, a.b1, a.w2, a.b2, a.w3,
                    a.b3);
    else
      mlp_wide_zero(f.w);
  }
};

// The forward (K2, with and without records).  Lanes owning components
// write the dense output and records, lane 0 t0, dt and the counters.
struct MLPDopri5Fwd : MLPWideChains<0> {
  static __device__ MLPDopri5Fwd load(const Args& a, Smem& sm, int C,
                                      int c) {
    MLPDopri5Fwd m;
    m.load_weights(a, sm, C, c);
    return m;
  }

  // The error norm's sums (field_stages.cuh): component i's ratio from the
  // lane carrying it, added as the per-chain loop adds them (even i into
  // sx, odd into sy, ascending), so every lane takes the same decision.
  __device__ __forceinline__ void norm_sums(const float* r, float& sx,
                                            float& sy) const {
    if constexpr (kMOwn == 1) {
#pragma unroll
      for (int i = 0; i < kMNS; ++i) {
        const float ri = __shfl_sync(kFull, r[0], i);
        if (i % 2 == 0) sx += ri * ri; else sy += ri * ri;
      }
    } else {
#pragma unroll
      for (int n = 0; n < kMN; ++n) {
        const float rx = __shfl_sync(kFull, r[0], n);
        const float ry = __shfl_sync(kFull, r[1], n);
        sx += rx * rx;
        sy += ry * ry;
      }
    }
  }

  __device__ void rhs(const float* y, float* out) const { f.rhs(y, out); }
};

// The backward (K3): the 7 stage points of a step in slots 0 (y0) to 6
// (u[5]), W2bar in AccSmem after the warp's buffer.
struct MLPDopri5 : MLPWideChains<7> {
  static constexpr int kStageSlots = 7;
  struct Grads {
    float *w1, *b1, *w2, *b2, *w3, *b3;
  };
  using AccSmem = MLPWideW2bar;
  using Acc = MLPWideAcc;

  static __device__ MLPDopri5 load(const Args& a, Smem& sm, int C, int c) {
    MLPDopri5 m;
    m.load_weights(a, sm, C, c);
    return m;
  }
  static __device__ Acc acc_init(AccSmem& s) {
    return mlp_wide_acc(s, threadIdx.x);
  }
  static __device__ void acc_store(const Acc& acc, const Grads& g, int c) {
    mlp_wide_store(acc, c, threadIdx.x, g.w1, g.b1, g.w2, g.b2, g.w3, g.b3);
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
