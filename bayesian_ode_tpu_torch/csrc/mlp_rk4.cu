// Fixed-grid rk4 (3/8 rule) trajectories of the MLP field and their
// gradient, one warp per chain (mlp_field.cuh says why).
//
// Replaces two TPU kernels of bayesian_ode_tpu/ops/mlp_rk4.py:
//   mlp_rk4_fwd: _make_fwd_kernel (K6), the T-1 steps on the output grid,
//                storing the whole trajectory;
//   mlp_rk4_bwd: _make_bwd_kernel (K7), the reverse sweep with the four
//                stages recomputed per step and the layer VJPs, returning
//                the 9 weight cotangents (here in the layer-list layout)
//                and the per-chain x0 cotangent.
// The TPU kernels compute the layer products in their own body; so do
// these, with no library matmul.
//
// What bounds it on an H100: latency of the serial per-chain chain of
// field evaluations.  A field evaluation at one point is 32 FMAs and 32
// shuffles per lane for the H x H layer, plus two 5-step butterfly sums;
// the VJP adds the transposed product through shared memory.  The weights
// are read once per chain into registers (40 per lane at H=32); each
// chain's trajectory row is written by lanes 0..2N-1.  10,112 chains are
// 10,112 warps in blocks of 4.
#include "mlp_field.cuh"
#include "rk4_common.cuh"

namespace bode {

__global__ void __launch_bounds__(kMLPBlock)
mlp_rk4_fwd_kernel(const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ w2, const float* __restrict__ b2,
                   const float* __restrict__ w3, const float* __restrict__ b3,
                   const float* __restrict__ x0,
                   const float* __restrict__ dts, int C, int T,
                   float* __restrict__ ys) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (c >= C) return;                    // whole warps leave together
  MLPField fld;
  fld.red = nullptr;
  fld.lane = lane;
  mlp_load(fld.w, c, lane, w1, b1, w2, b2, w3, b3);

  float y[kMNS], y1[kMNS];
#pragma unroll
  for (int i = 0; i < kMNS; ++i) y[i] = x0[i];
  if (lane < kMNS) ys[static_cast<size_t>(c) * kMNS + lane] = x0[lane];
  for (int t = 0; t < T - 1; ++t) {
    rk4_step<kMNS>(fld, y, dts[t], y1);
    float mine = 0.f;
#pragma unroll
    for (int i = 0; i < kMNS; ++i) {
      if (lane == i) mine = y1[i];
      y[i] = y1[i];
    }
    if (lane < kMNS)
      ys[(static_cast<size_t>(t + 1) * C + c) * kMNS + lane] = mine;
  }
}

__global__ void __launch_bounds__(kMLPBlock)
mlp_rk4_bwd_kernel(const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ w2, const float* __restrict__ b2,
                   const float* __restrict__ w3, const float* __restrict__ b3,
                   const float* __restrict__ dts,
                   const float* __restrict__ ys, const float* __restrict__ g,
                   int C, int T, float* __restrict__ gw1,
                   float* __restrict__ gb1, float* __restrict__ gw2,
                   float* __restrict__ gb2, float* __restrict__ gw3,
                   float* __restrict__ gb3, float* __restrict__ lbar) {
  __shared__ float red[kWarpsPerBlock][32 * kRed];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * kWarpsPerBlock + warp;
  if (c >= C) return;
  MLPField fld;
  fld.red = red[warp];
  fld.lane = lane;
  mlp_load(fld.w, c, lane, w1, b1, w2, b2, w3, b3);
  MLPUnit acc;
  mlp_zero(acc);

  float l[kMNS], p[kMNS];
#pragma unroll
  for (int i = 0; i < kMNS; ++i) l[i] = 0.f;
  for (int t = T - 2; t >= 0; --t) {
    const float* gt = g + (static_cast<size_t>(t + 1) * C + c) * kMNS;
    const float* pt = ys + (static_cast<size_t>(t) * C + c) * kMNS;
#pragma unroll
    for (int i = 0; i < kMNS; ++i) {
      l[i] = l[i] + gt[i];
      p[i] = pt[i];
    }
    rk4_step_vjp<kMNS>(fld, p, dts[t], l, acc);
  }
  // x0's own observation term
  float mine = 0.f;
#pragma unroll
  for (int i = 0; i < kMNS; ++i)
    if (lane == i) mine = l[i] + g[static_cast<size_t>(c) * kMNS + i];
  if (lane < kMNS) lbar[static_cast<size_t>(c) * kMNS + lane] = mine;
  mlp_store(acc, c, lane, gw1, gb1, gw2, gb2, gw3, gb3);
}

}  // namespace bode

extern "C" {

// Dimensions this library was built for.
int mlp_rk4_dims(int* n_points, int* hidden) {
  *n_points = bode::kMN;
  *hidden = bode::kH;
  return 0;
}

// ys (T, C, N, 2) from the layer list w1 (C, 2, H), b1 (C, H), w2 (C, H, H),
// b2 (C, H), w3 (C, H, 2), b3 (C, 2), x0 (N, 2) shared, dts (T-1,).
// Returns cudaGetLastError().
int mlp_rk4_fwd(const float* w1, const float* b1, const float* w2,
                const float* b2, const float* w3, const float* b3,
                const float* x0, const float* dts, int C, int T, float* ys,
                cudaStream_t stream) {
  const dim3 grid((C + bode::kWarpsPerBlock - 1) / bode::kWarpsPerBlock);
  bode::mlp_rk4_fwd_kernel<<<grid, bode::kMLPBlock, 0, stream>>>(
      w1, b1, w2, b2, w3, b3, x0, dts, C, T, ys);
  return static_cast<int>(cudaGetLastError());
}

// The weight cotangents in the layout of the weights, and lbar (C, N, 2),
// the per-chain x0 cotangent including g[0], from the trajectory ys and
// its cotangent g, both (T, C, N, 2).  Returns cudaGetLastError().
int mlp_rk4_bwd(const float* w1, const float* b1, const float* w2,
                const float* b2, const float* w3, const float* b3,
                const float* dts, const float* ys, const float* g, int C,
                int T, float* gw1, float* gb1, float* gw2, float* gb2,
                float* gw3, float* gb3, float* lbar, cudaStream_t stream) {
  const dim3 grid((C + bode::kWarpsPerBlock - 1) / bode::kWarpsPerBlock);
  bode::mlp_rk4_bwd_kernel<<<grid, bode::kMLPBlock, 0, stream>>>(
      w1, b1, w2, b2, w3, b3, dts, ys, g, C, T, gw1, gb1, gw2, gb2, gw3,
      gb3, lbar);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
