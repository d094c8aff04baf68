// The GP field past one warp or past a block's shared memory: N > 32
// trajectory points (to N = 128), or an inducing grid whose GPPoint block
// passes the 232,448 B of dynamic shared memory a block may have (to
// M = 1,024; K3 and K5 from a 15x15 grid on at N = 5, the forwards at
// N <= 4 from a few hundred points on).  gp_field.cuh takes GPWidePoint
// for each kernel whose GPPoint block does not fit (gp_narrow); every
// other instance keeps GPPoint.
//
// Still one trajectory point a thread, with GPPoint's registers, its rhs
// (each sum in ascending m) and its error norm in the per-chain order, so
// a wide forward takes the steps GPPoint would, bit for bit:
//   - A chain spans kGW = ceil(N/32) warps.  Past N = 32 a block is one
//     chain (thread t carries point t; threads past N - 1 mirror point
//     N - 1, write nothing and add nothing), and the error norm's ratios
//     go through shared memory: each point's thread writes its pair, a
//     __syncthreads(), every thread adds the N pairs in ascending n, a
//     second __syncthreads() before the next step's writes.  Every thread
//     of the block takes the chain's decisions, so all reach the barriers.
//   - To N = 32, chains are packed N consecutive lanes each as in GPPoint,
//     but only as many a warp (kGWCPW) and warps a block as keep A, the
//     grid and the sweeps' Abar columns in one block: 16 B an inducing
//     point a chain and 8 B a point for Z.
//   - Abar: one column a segment (a chain's lanes in one warp), not one a
//     thread.  At each VJP term the segment's points' shares are summed by
//     a tree of shuffles (offsets 1, 2, 4, ...; lanes past the segment add
//     nothing) and its first lane adds the sum to the column.  GPPoint's
//     columns took 1,024 B an inducing point a block; these take 8 B a
//     chain (and a warp past N = 32), so M = 1,024 fits.  The sum over
//     points is the only reassociation (a tree where GPPoint adds its N
//     partials in ascending n at the end), well inside K3's 1e-3 and K5's
//     1e-5 gates.  acc_store writes a chain's column (past N = 32 the sum
//     of its warps' columns, in warp order) with the chain's lanes.
// Past N = 32 the shuffles' mask is the full warp (every lane of a wide
// chain's warps stays in its loops); to N = 32 it is the chain's lanes,
// since the chains of a warp leave their loops at different steps.
//
// What bounds it on an H100: as GPPoint, the FP32 and expf work of the
// field, now with fewer warps an SM where the blocks are large (two 6-chain
// warps a block, one block an SM, in K3 at N = 5, M = 1,024) and 2 log2(N)
// shuffles a VJP term for the Abar tree.
#pragma once

namespace bode {

constexpr long kGPSmemMax = 232448;         // an sm_90 block's dynamic max
constexpr int kGW = (kN + 31) / 32;         // warps a chain

// Chains a warp: one past N = 32, else as many of 32 / N as keep a
// warp's A and Abar columns and the grid within a block.
constexpr int gp_wide_chains_per_warp() {
  if (kGW > 1) return 1;
  const long fit = (kGPSmemMax - 8L * kM) / (16L * kM);
  return fit < 32 / kN ? static_cast<int>(fit) : 32 / kN;
}
constexpr int kGWCPW = gp_wide_chains_per_warp();

// Warps a block: a chain's past N = 32, else the most of 4, 2 and 1 whose
// chains' buffers fit.
constexpr int gp_wide_warps() {
  if (kGW > 1) return kGW;
  int w = 4;
  while (w > 1 && 16L * kM * kGWCPW * w + 8L * kM > kGPSmemMax) w /= 2;
  return w;
}

struct GPWidePoint {
  static_assert(kN >= 1 && kN <= 128, "the wide GP field takes N <= 128");
  static_assert(kGWCPW >= 1, "a chain's buffers must fit a block");
  static constexpr int kNS = 2 * GP_N;
  static constexpr int kOwn = 2;            // a thread's: its point's x, y
  static constexpr int kWarps = gp_wide_warps();
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kChains = kGW > 1 ? 1 : kWarps * kGWCPW;
  static constexpr int kSegs = kGW > 1 ? kGW : kChains;  // Abar columns
  static constexpr int kSegLanes = kGW > 1 ? 32 : kN;    // a segment's most
  // at most 128 registers a thread, as GPPoint's kMinBlocks = 4 at 128
  static constexpr int kMinBlocks = 512 / kThreads;
  // acc_store is collective over a chain's lanes: every lane reaches it
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
    float2 sR[kGW > 1 ? kN : 1];    // the error norm's ratios, past N = 32
  };
  struct AccSmem {
    float2 sAbar[kM * kSegs];       // segment s's column: sAbar[m * kSegs + s]
  };
  struct Acc {
    float2* s;         // this thread's segment's column, s[m * kSegs]
  };

  const float2* sA;      // this chain's column: sA[m * kChains]
  const float2* sZ;
  float2* sR;
  float sf2, inv2ell2, invell2;

  static __device__ int lane() { return threadIdx.x & 31; }
  // this thread's point before mirroring (past N - 1 on the threads of a
  // wide chain's last warp that carry none)
  static __device__ int raw_point() {
    return kGW > 1 ? static_cast<int>(threadIdx.x) : lane() % kN;
  }
  static __device__ int point() { return min(raw_point(), kN - 1); }
  // this thread's chain; a lane past the warp's last chain has none
  // (returns a count past any C)
  static __device__ int chain() {
    if constexpr (kGW > 1) return blockIdx.x;
    return lane() < kGWCPW * kN
               ? blockIdx.x * kChains + (threadIdx.x >> 5) * kGWCPW
                     + lane() / kN
               : 0x7fffffff;
  }
  static __device__ int comp(int q) { return 2 * point() + q; }
  static __device__ bool owner() { return raw_point() < kN; }
  static __device__ bool leader() { return raw_point() == 0; }
  // this thread's Abar segment in the block, its place in it, its length
  static __device__ int segment() {
    if constexpr (kGW > 1) return threadIdx.x >> 5;
    return (threadIdx.x >> 5) * kGWCPW + min(lane() / kN, kGWCPW - 1);
  }
  static __device__ int seg_index() { return kGW > 1 ? lane() : point(); }
  static __device__ int seg_len() {
    return kGW > 1 ? min(32, kN - 32 * static_cast<int>(threadIdx.x >> 5))
                   : kN;
  }
  // the lanes of this thread's chain in its warp
  static __device__ unsigned chain_mask() {
    if constexpr (kGW > 1) return kFull;
    const unsigned m = kN == 32 ? kFull : (1u << (kN % 32)) - 1u;
    return m << (lane() - point());
  }

  // Stage the block's A and Z (gp_stage); called by every thread of the
  // block.
  static __device__ GPWidePoint load(const Args& a, Smem& sm, int C, int) {
    gp_stage<kChains, kThreads>(a.A, a.Z, sm.sA, sm.sZ, C);
    return GPWidePoint{sm.sA + (kGW > 1 ? 0 : segment()), sm.sZ, sm.sR,
                       a.sf2, a.inv2ell2, a.invell2};
  }
  // Zero the block's columns; called by every thread of the block.
  static __device__ Acc acc_init(AccSmem& s) {
    for (int i = threadIdx.x; i < kM * kSegs; i += kThreads)
      s.sAbar[i] = float2{0.f, 0.f};
    __syncthreads();
    return Acc{s.sAbar + segment()};
  }

  // Abar of chain c, written by the chain's lanes (c < 0: none, it writes
  // nothing).  Past N = 32 the sum of its warps' columns in warp order,
  // after a block barrier; to N = 32 its column, after a barrier of the
  // chain's lanes (its first lane wrote it).
  static __device__ void acc_store(const Acc& acc, const Grads& g, int c) {
    if constexpr (kGW > 1) {
      __syncthreads();
      const float2* col = acc.s - segment();
      float2* out = reinterpret_cast<float2*>(g.A)
                    + static_cast<size_t>(c) * kM;
      for (int m = threadIdx.x; m < kM; m += kThreads) {
        float2 s = col[m * kSegs];
#pragma unroll
        for (int w = 1; w < kGW; ++w) {
          s.x += col[m * kSegs + w].x;
          s.y += col[m * kSegs + w].y;
        }
        out[m] = s;
      }
    } else {
      if (c < 0) return;
      __syncwarp(chain_mask());
      float2* out = reinterpret_cast<float2*>(g.A)
                    + static_cast<size_t>(c) * kM;
      for (int m = point(); m < kM; m += kN) out[m] = acc.s[m * kSegs];
    }
  }

  // The error norm's sums: point q's ratios added as the per-chain loop
  // adds them, q = 0..N-1 (GPPoint::norm_sums to N = 32; past it through
  // the block's shared memory, between two barriers).
  __device__ __forceinline__ void norm_sums(const float* r, float& sx,
                                            float& sy) const {
    if constexpr (kGW > 1) {
      if (owner()) sR[threadIdx.x] = float2{r[0], r[1]};
      __syncthreads();
#pragma unroll 8
      for (int q = 0; q < kN; ++q) {
        const float2 v = sR[q];
        sx += v.x * v.x;
        sy += v.y * v.y;
      }
      __syncthreads();
    } else {
      gp_warp_norm_sums(chain_mask(), lane() - point(), r, sx, sy);
    }
  }

  // f = K(y, Z) A at this thread's point, as GPPoint's.
  __device__ __forceinline__ void rhs(const float* y, float* f) const {
    gp_rhs<kChains>(sA, sZ, sf2, inv2ell2, y, f);
  }

  // Vector-Jacobian product at this point y for the cotangent `cot` of
  // f(y): ybar = (d f / d y)^T cot into this thread's registers, as
  // GPPoint; Abar += (d f / d A)^T cot summed over the segment's points
  // at each m into its column.  Z gets no cotangent.
  __device__ __forceinline__ void rhs_vjp(const float* y, const float* cot,
                                          float* ybar, Acc& acc) const {
    const float px = y[0], py = y[1];
    const float cx = cot[0], cy = cot[1];
    const unsigned mask = chain_mask();
    const int i = seg_index();
    const int len = seg_len();
    float ubx = 0.f, uby = 0.f;
#pragma unroll 4
    for (int m = 0; m < kM; ++m) {
      float ax = 0.f, ay = 0.f;
      gp_vjp_term<kChains>(sA, sZ, sf2, inv2ell2, invell2, m, px, py, cx,
                           cy, ax, ay, ubx, uby);
#pragma unroll
      for (int off = 1; off < kSegLanes; off *= 2) {
        const float ox = __shfl_down_sync(mask, ax, off);
        const float oy = __shfl_down_sync(mask, ay, off);
        if (i + off < len) {
          ax += ox;
          ay += oy;
        }
      }
      if (i == 0) {
        float2 s = acc.s[m * kSegs];
        s.x += ax;
        s.y += ay;
        acc.s[m * kSegs] = s;
      }
    }
    ybar[0] = ubx;
    ybar[1] = uby;
  }
};

}  // namespace bode
