// Fixed-grid rk4 (3/8 rule) trajectories of the GP field and their
// gradient, one chain per thread.
//
// Replaces two TPU kernels of bayesian_ode_tpu/ops/gp_rk4.py:
//   gp_rk4_fwd: _make_fwd_kernel (K4), the T-1 steps on the output grid,
//               storing the whole trajectory (the output, and the residual
//               of the backward);
//   gp_rk4_bwd: _make_bwd_kernel (K5), the reverse sweep: at step t it
//               injects the observation cotangent g[t+1], recomputes the
//               four stages from the stored trajectory point and pulls the
//               cotangent through the field VJP, accumulating Abar.
//
// What bounds it on an H100: latency, as for the dopri5 kernels.  A step
// costs 4 x N x M = 720 expf (K5: 8 x N x M) at N=5, M=36, and each chain
// reads and writes only its own state and trajectory rows; A (M x 2 per
// chain) and the grid Z sit in shared memory.  Blocks of 64 threads give
// 158 blocks at 10,112 chains, so all 132 SMs get work.  K5 keeps Abar per
// chain in shared memory and writes it once, with no atomics, so gradients
// are deterministic; x0bar is returned per chain and summed outside.
#include "gp_field.cuh"
#include "rk4_common.cuh"

namespace bode {

__global__ void __launch_bounds__(kBlock)
gp_rk4_fwd_kernel(const float* __restrict__ A, const float* __restrict__ x0,
                  const float* __restrict__ Z, const float* __restrict__ dts,
                  int C, int T, float sf2, float inv2ell2,
                  float* __restrict__ ys) {
  __shared__ float sA[2 * kM * kBlock];
  __shared__ float sZ[2 * kM];
  stage_weights(A, Z, C, sA, sZ);
  __syncthreads();

  const int c = blockIdx.x * kBlock + threadIdx.x;
  if (c >= C) return;
  const GPField fld{sA, sZ, static_cast<int>(threadIdx.x), sf2, inv2ell2,
                    0.f};
  float y[kNS], y1[kNS];
#pragma unroll
  for (int i = 0; i < kNS; ++i) {
    y[i] = x0[i];
    ys[static_cast<size_t>(c) * kNS + i] = y[i];
  }
  for (int t = 0; t < T - 1; ++t) {
    rk4_step<kNS>(fld, y, dts[t], y1);
    float* out = ys + (static_cast<size_t>(t + 1) * C + c) * kNS;
#pragma unroll
    for (int i = 0; i < kNS; ++i) {
      out[i] = y1[i];
      y[i] = y1[i];
    }
  }
}

__global__ void __launch_bounds__(kBlock)
gp_rk4_bwd_kernel(const float* __restrict__ A, const float* __restrict__ Z,
                  const float* __restrict__ dts,
                  const float* __restrict__ ys, const float* __restrict__ g,
                  int C, int T, float sf2, float inv2ell2, float invell2,
                  float* __restrict__ Abar, float* __restrict__ lbar) {
  __shared__ float sA[2 * kM * kBlock];
  __shared__ float sAbar[2 * kM * kBlock];
  __shared__ float sZ[2 * kM];
  stage_weights(A, Z, C, sA, sZ);
  for (int idx = threadIdx.x; idx < 2 * kM * kBlock; idx += kBlock)
    sAbar[idx] = 0.f;
  __syncthreads();

  const int c = blockIdx.x * kBlock + threadIdx.x;
  if (c >= C) return;
  const int lane = threadIdx.x;
  const GPField fld{sA, sZ, lane, sf2, inv2ell2, invell2};
  float* acc = sAbar;

  float l[kNS], p[kNS];
#pragma unroll
  for (int i = 0; i < kNS; ++i) l[i] = 0.f;
  for (int t = T - 2; t >= 0; --t) {
    const float* gt = g + (static_cast<size_t>(t + 1) * C + c) * kNS;
    const float* pt = ys + (static_cast<size_t>(t) * C + c) * kNS;
#pragma unroll
    for (int i = 0; i < kNS; ++i) {
      l[i] = l[i] + gt[i];
      p[i] = pt[i];
    }
    rk4_step_vjp<kNS>(fld, p, dts[t], l, acc);
  }
  // x0's own observation term
#pragma unroll
  for (int i = 0; i < kNS; ++i)
    lbar[static_cast<size_t>(c) * kNS + i] =
        l[i] + g[static_cast<size_t>(c) * kNS + i];
  for (int j = 0; j < 2 * kM; ++j)
    Abar[static_cast<size_t>(c) * 2 * kM + j] = sAbar[j * kBlock + lane];
}

}  // namespace bode

extern "C" {

// Dimensions this library was built for.
int gp_rk4_dims(int* n_points, int* n_inducing) {
  *n_points = bode::kN;
  *n_inducing = bode::kM;
  return 0;
}

// ys (T, C, N, 2) from A (C, M, 2), x0 (N, 2) shared, Z (M, 2), dts (T-1,).
// Returns cudaGetLastError().
int gp_rk4_fwd(const float* A, const float* x0, const float* Z,
               const float* dts, int C, int T, float sf2, float inv2ell2,
               float* ys, cudaStream_t stream) {
  const dim3 grid((C + bode::kBlock - 1) / bode::kBlock);
  bode::gp_rk4_fwd_kernel<<<grid, bode::kBlock, 0, stream>>>(
      A, x0, Z, dts, C, T, sf2, inv2ell2, ys);
  return static_cast<int>(cudaGetLastError());
}

// Abar (C, M, 2) and lbar (C, N, 2), the per-chain x0 cotangent including
// g[0], from the trajectory ys and its cotangent g, both (T, C, N, 2).
// Returns cudaGetLastError().
int gp_rk4_bwd(const float* A, const float* Z, const float* dts,
               const float* ys, const float* g, int C, int T, float sf2,
               float inv2ell2, float invell2, float* Abar, float* lbar,
               cudaStream_t stream) {
  const dim3 grid((C + bode::kBlock - 1) / bode::kBlock);
  bode::gp_rk4_bwd_kernel<<<grid, bode::kBlock, 0, stream>>>(
      A, Z, dts, ys, g, C, T, sf2, inv2ell2, invell2, Abar, lbar);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
