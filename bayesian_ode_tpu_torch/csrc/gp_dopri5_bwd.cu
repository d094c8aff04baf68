// Frozen-step-mesh discrete adjoint of the whole dopri5 solve, one chain
// per thread.
//
// Replaces bayesian_ode_tpu/ops/fused_adaptive.py::make_bwd_kernel (K3)
// over the GP field VJP of bayesian_ode_tpu/ops/gp_dopri5_grad.py::
// _make_rhs_vjp.  Per recorded (accepted) step, in reverse:
//   1. recompute the 7 stage derivatives from the stored start state;
//   2. pull the cotangents of the output times this step emitted back
//      through the Horner evaluation and the quartic-coefficient map to
//      (y0, y1, y_mid, f0, f1);
//   3. pull them through y_mid = y0 + dt * (c_mid . k);
//   4. pull them through the transposed stage recurrence, calling the
//      field VJP at each stage point and accumulating Abar.
// Step sizes are constants of the backward pass.
//
// What bounds it on an H100: latency.  A step costs 7 field evaluations
// plus 7 VJPs (each N x M expf) and keeps 6 stage points and 7 stage
// cotangents live (13 x 2N floats).  At N=5 ptxas fits them in 214
// registers a thread with no spills (64-thread blocks may use up to 255).
// That caps an SM at 4 such blocks, but at 10,112 chains the 158 blocks
// give most SMs one block (2 warps) anyway: each thread's serial chain of
// expf and FMAs sets the time, and more chains, or more threads per chain,
// are what would fill the card.  Abar is accumulated per chain in shared
// memory (M x 2 floats per thread) and written once, with no atomics, so
// gradients are deterministic.  x0bar is returned per chain; the sum over
// chains is done outside, as in the JAX package.
#include "dopri5_common.cuh"

namespace bode {

__global__ void __launch_bounds__(kBlock)
gp_dopri5_bwd_kernel(const float* __restrict__ A,
                     const float* __restrict__ Z,
                     const float* __restrict__ ts,
                     const float* __restrict__ rec,
                     const int* __restrict__ nrec,
                     const float* __restrict__ g,
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

  float l[kNS];
#pragma unroll
  for (int i = 0; i < kNS; ++i) l[i] = 0.f;
  int p = T - 1;

  for (int s = nrec[c] - 1; s >= 0; --s) {
    const float* row = rec + static_cast<size_t>(s) * kRec * C + c;
    float y0[kNS];
#pragma unroll
    for (int i = 0; i < kNS; ++i) y0[i] = row[static_cast<size_t>(i) * C];
    const float t0 = row[static_cast<size_t>(kNS) * C];
    const float dt = row[static_cast<size_t>(kNS + 1) * C];
    const float dts = dt > 0.f ? dt : 1.0f;

    // 1. recompute the stages, keeping the stage points u[0..5]
    float k[7][kNS], u[6][kNS];
    fld.rhs(y0, k[0]);
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      stage_point(r, y0, k, dts, u[r]);
      fld.rhs(u[r], k[r + 1]);
    }

    // 2. cotangents of the emitted output times -> quartic coefficients
    float ca[kNS], cb[kNS], cc[kNS], cd[kNS], ce[kNS];
#pragma unroll
    for (int i = 0; i < kNS; ++i) ca[i] = cb[i] = cc[i] = cd[i] = ce[i] = 0.f;
    const float tn = t0 + dt;
    while (p >= 1 && ts[p] > tn) --p;      // never reached: no cotangent
    for (; p >= 1 && ts[p] > t0; --p) {
      const float X1 = (ts[p] - t0) / dts;
      const float X2 = X1 * X1;
      const float X3 = X2 * X1;
      const float X4 = X2 * X2;
      const float* gp = g + (static_cast<size_t>(p) * C + c) * kNS;
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        const float w = gp[i];
        ca[i] += w * X4;
        cb[i] += w * X3;
        cc[i] += w * X2;
        cd[i] += w * X1;
        ce[i] += w;
      }
    }

    float y0b[kNS], y1b[kNS], f0b[kNS], f1b[kNS], kb[7][kNS];
#pragma unroll
    for (int i = 0; i < kNS; ++i) {
      const float a = ca[i], b = cb[i], cq = cc[i], d = cd[i], e = ce[i];
      y0b[i] = -8.0f * a + 18.0f * b - 11.0f * cq + e;
      y1b[i] = -8.0f * a + 14.0f * b - 5.0f * cq;
      const float ymb = 16.0f * a - 32.0f * b + 16.0f * cq;
      f0b[i] = dts * (-2.0f * a + 5.0f * b - 4.0f * cq + d);
      f1b[i] = dts * (2.0f * a - 3.0f * b + cq);
      // 3. y_mid = y0 + dt * (c_mid . k)
#pragma unroll
      for (int j = 0; j < 7; ++j) {
        const float cm = static_cast<float>(c_mid_d(j));
        kb[j][i] = cm != 0.f ? (dts * cm) * ymb : 0.f;
      }
      y0b[i] += ymb;
    }

    // 4. transposed stage recurrence
    float cot[kNS], ub[kNS];
    // k7 = f(y1): its cotangent is the carried-in f1 share + the c_mid share
#pragma unroll
    for (int i = 0; i < kNS; ++i) cot[i] = kb[6][i] + f1b[i];
    fld.rhs_vjp(u[5], cot, ub, sAbar);
    // y1 = y0 + dt * (beta[5] . k)
#pragma unroll
    for (int i = 0; i < kNS; ++i) {
      const float y1t = l[i] + y1b[i] + ub[i];
      y0b[i] += y1t;
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const float b = static_cast<float>(beta_d(5, j));
        if (b != 0.f) kb[j][i] += (dts * b) * y1t;
      }
    }
    // stages 6..2: k[r + 1] = f(u[r]), u[r] = y0 + dt * (beta[r] . k)
#pragma unroll
    for (int r = 4; r >= 0; --r) {
      fld.rhs_vjp(u[r], kb[r + 1], ub, sAbar);
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        y0b[i] += ub[i];
#pragma unroll
        for (int j = 0; j <= 4; ++j) {
          if (j > r) break;
          const float b = static_cast<float>(beta_d(r, j));
          if (b != 0.f) kb[j][i] += (dts * b) * ub[i];
        }
      }
    }
    // k1 = f(y0): the FSAL slope is recomputed, so f0's share lands here
#pragma unroll
    for (int i = 0; i < kNS; ++i) cot[i] = kb[0][i] + f0b[i];
    fld.rhs_vjp(y0, cot, ub, sAbar);
#pragma unroll
    for (int i = 0; i < kNS; ++i) l[i] = y0b[i] + ub[i];
  }

#pragma unroll
  for (int i = 0; i < kNS; ++i) lbar[static_cast<size_t>(c) * kNS + i] = l[i];
  for (int j = 0; j < 2 * kM; ++j)
    Abar[static_cast<size_t>(c) * 2 * kM + j] = sAbar[j * kBlock + lane];
}

}  // namespace bode

extern "C" {

// Abar (C, M, 2) and lbar (C, N, 2), the per-chain x0 cotangent.
// Returns cudaGetLastError().
int gp_dopri5_bwd(const float* A, const float* Z, const float* ts,
                  const float* rec, const int* nrec, const float* g, int C,
                  int T, float sf2, float inv2ell2, float invell2,
                  float* Abar, float* lbar, cudaStream_t stream) {
  const dim3 grid((C + bode::kBlock - 1) / bode::kBlock);
  bode::gp_dopri5_bwd_kernel<<<grid, bode::kBlock, 0, stream>>>(
      A, Z, ts, rec, nrec, g, C, T, sf2, inv2ell2, invell2, Abar, lbar);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
