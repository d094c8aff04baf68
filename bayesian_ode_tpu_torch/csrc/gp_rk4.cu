// Fixed-grid rk4 (3/8 rule) trajectories of the GP field and their
// gradient, one trajectory point per thread (GPPoint in gp_field.cuh).
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
// What bounds them on an H100: the field's FP32 and expf throughput, with
// latency to hide.  A forward step costs 4 x N x M = 720 expf at N=5,
// M=36; each chain reads and writes only its own state and trajectory
// rows; A (M x 2 per chain) and the grid Z sit in shared memory.  The
// steps are on the fixed output grid, so a chain's N points step
// independently in both directions (they share only A, and Abar in the
// sweep): both kernels run one thread per point, N consecutive lanes a
// chain, 1,686 warps at 10,112 chains where one chain per thread gave 316,
// each thread's serial chain of expf and FMAs N times shorter, and
// neighbouring lanes read and write neighbouring words of ys and g.
// K4's thread keeps its point's 2 components and the step's stage arrays
// in registers (rk4_step<2> over GPPoint's one-point rhs, the per-chain
// field's expressions in the same order over m, so the trajectories are
// the one chain a thread kernel's).  K5's keeps its point's Abar, for 12
// inducing points in registers and for the rest in its own column of
// shared memory; the chain's N partials are summed by warp shuffles at the
// end, with no atomics, so gradients are deterministic; x0bar is returned
// per chain and summed outside.  Both blocks' buffers are in dynamic
// shared memory.  Past N = 32, or where GPPoint's block passes a block's
// shared memory, each kernel runs on GPWidePoint instead (gp_field.cuh,
// gp_wide_field.cuh: a chain over several warps, or fewer chains a block,
// and K5's Abar one column a chain, its points' shares summed by shuffles
// at each term).
#include "gp_field.cuh"
#include "rk4_common.cuh"

namespace bode {

__global__ void __launch_bounds__(GPFwdPoint::kThreads,
                                  GPFwdPoint::kMinBlocks)
gp_rk4_fwd_kernel(const float* __restrict__ A, const float* __restrict__ x0,
                  const float* __restrict__ Z, const float* __restrict__ dts,
                  int C, int T, float sf2, float inv2ell2,
                  float* __restrict__ ys) {
  using P = GPFwdPoint;
  const int c = P::chain();
  const P fld = P::load(P::Args{A, Z, sf2, inv2ell2, 0.f}, block_smem<P>(),
                        C, c);
  if (c >= C) return;        // no warp collective follows
  const int j = P::comp(0);
  const bool own = P::owner();   // GPWidePoint: not a mirrored point
  float y[2] = {x0[j], x0[j + 1]}, y1[2];
  float* out = ys + static_cast<size_t>(c) * kNS + j;
  if (own) {
    out[0] = y[0];
    out[1] = y[1];
  }
  const size_t row = static_cast<size_t>(C) * kNS;
  for (int t = 0; t < T - 1; ++t) {
    rk4_step<2>(fld, y, dts[t], y1);
    out += row;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (own) out[i] = y1[i];
      y[i] = y1[i];
    }
  }
}

__global__ void __launch_bounds__(GPRk4Point::kThreads,
                                  GPRk4Point::kMinBlocks)
gp_rk4_bwd_kernel(const float* __restrict__ A, const float* __restrict__ Z,
                  const float* __restrict__ dts,
                  const float* __restrict__ ys, const float* __restrict__ g,
                  int C, int T, float sf2, float inv2ell2, float invell2,
                  float* __restrict__ Abar, float* __restrict__ lbar) {
  using P = GPRk4Point;
  const int c = P::chain();
  const P fld = P::load(P::Args{A, Z, sf2, inv2ell2, invell2},
                        block_smem<P>(), C, c);
  P::Acc acc = P::acc_init(block_acc_smem<P>());
  // every lane stays to the warp sum of acc_store; a lane with no chain
  // sweeps nothing
  if (c < C) {
    const size_t q = static_cast<size_t>(c) * kNS + P::comp(0);
    float l[2] = {0.f, 0.f}, p[2];
    for (int t = T - 2; t >= 0; --t) {
      const float* gt = g + static_cast<size_t>(t + 1) * C * kNS + q;
      const float* pt = ys + static_cast<size_t>(t) * C * kNS + q;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] = l[i] + gt[i];
        p[i] = pt[i];
      }
      rk4_step_vjp<2>(fld, p, dts[t], l, acc);
    }
    // x0's own observation term
    if (P::owner()) {
#pragma unroll
      for (int i = 0; i < 2; ++i) lbar[q + i] = l[i] + g[q + i];
    }
  }
  P::acc_store(acc, P::Grads{Abar}, c < C ? c : -1);
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
// Returns cudaGetLastError() (or the error of raising the block's
// shared-memory limit).
int gp_rk4_fwd(const float* A, const float* x0, const float* Z,
               const float* dts, int C, int T, float sf2, float inv2ell2,
               float* ys, cudaStream_t stream) {
  using P = bode::GPFwdPoint;
  constexpr size_t bytes = bode::smem_bytes<P, false>();
  static const cudaError_t allowed =
      bode::allow_smem(bode::gp_rk4_fwd_kernel, bytes);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  const dim3 grid((C + P::kChains - 1) / P::kChains);
  bode::gp_rk4_fwd_kernel<<<grid, P::kThreads, bytes, stream>>>(
      A, x0, Z, dts, C, T, sf2, inv2ell2, ys);
  return static_cast<int>(cudaGetLastError());
}

// Abar (C, M, 2) and lbar (C, N, 2), the per-chain x0 cotangent including
// g[0], from the trajectory ys and its cotangent g, both (T, C, N, 2).
// Returns cudaGetLastError() (or the error of raising the block's
// shared-memory limit).
int gp_rk4_bwd(const float* A, const float* Z, const float* dts,
               const float* ys, const float* g, int C, int T, float sf2,
               float inv2ell2, float invell2, float* Abar, float* lbar,
               cudaStream_t stream) {
  using P = bode::GPRk4Point;
  constexpr size_t bytes = bode::smem_bytes<P, true>();
  static const cudaError_t allowed =
      bode::allow_smem(bode::gp_rk4_bwd_kernel, bytes);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  const dim3 grid((C + P::kChains - 1) / P::kChains);
  bode::gp_rk4_bwd_kernel<<<grid, P::kThreads, bytes, stream>>>(
      A, Z, dts, ys, g, C, T, sf2, inv2ell2, invell2, Abar, lbar);
  return static_cast<int>(cudaGetLastError());
}

// The shared memory of a block of K4 and of K5, static and dynamic.
int gp_rk4_smem(int* bytes) {
  using bode::GPFwdPoint;
  using bode::GPRk4Point;
  cudaError_t e = bode::kernel_smem(
      bode::gp_rk4_fwd_kernel, bode::smem_bytes<GPFwdPoint, false>(),
      bytes);
  if (e == cudaSuccess)
    e = bode::kernel_smem(bode::gp_rk4_bwd_kernel,
                          bode::smem_bytes<GPRk4Point, true>(), bytes + 1);
  return static_cast<int>(e);
}

}  // extern "C"
