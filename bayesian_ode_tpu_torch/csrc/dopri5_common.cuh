// Shared device code of the fused adaptive dopri5 kernels (Hopper, sm_90a).
//
// The step arithmetic lives here once, as in the JAX package's
// ops/gp_dopri5.py (_rk_stages, _step_decision, _quartic_coeffs,
// _midpoint), so the non-recording whole solve (K1) and the recording
// forward (K2) are one template and produce the same trajectories bit for
// bit.  The field is a functor; the GP kernel-regression field is its only
// instance so far:
//
//   f(x_n) = sum_m sf^2 exp(-|x_n - z_m|^2 / (2 ell^2)) A_m
//
// State layout per chain: NS = 2 * GP_N floats, y[2n + d] (the JAX (N, 2)
// layout).  Full float32 throughout: built without --use_fast_math and with
// expf, because reduced-precision right-hand sides shrink adaptive step
// sizes.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#ifndef GP_N
#error "GP_N (trajectory points per chain) must be defined at build time"
#endif
#ifndef GP_M
#error "GP_M (inducing points) must be defined at build time"
#endif

namespace bode {

constexpr int kBlock = 64;       // threads per block, one chain per thread
constexpr int kN = GP_N;
constexpr int kM = GP_M;
constexpr int kNS = 2 * GP_N;    // state components per chain
constexpr int kRec = kNS + 2;    // record row: y0[kNS], t0, dt

// ---- Dormand-Prince 5(4) tableau (ode/tableaus.py DOPRI5) ----
__host__ __device__ constexpr double beta_d(int r, int j) {
  switch (r * 8 + j) {
    case 0: return 1.0 / 5;
    case 8: return 3.0 / 40;
    case 9: return 9.0 / 40;
    case 16: return 44.0 / 45;
    case 17: return -56.0 / 15;
    case 18: return 32.0 / 9;
    case 24: return 19372.0 / 6561;
    case 25: return -25360.0 / 2187;
    case 26: return 64448.0 / 6561;
    case 27: return -212.0 / 729;
    case 32: return 9017.0 / 3168;
    case 33: return -355.0 / 33;
    case 34: return 46732.0 / 5247;
    case 35: return 49.0 / 176;
    case 36: return -5103.0 / 18656;
    case 40: return 35.0 / 384;
    case 41: return 0.0;
    case 42: return 500.0 / 1113;
    case 43: return 125.0 / 192;
    case 44: return -2187.0 / 6784;
    case 45: return 11.0 / 84;
    default: return 0.0;
  }
}

__host__ __device__ constexpr double c_err_d(int j) {
  switch (j) {
    case 0: return 35.0 / 384 - 1951.0 / 21600;
    case 2: return 500.0 / 1113 - 22642.0 / 50085;
    case 3: return 125.0 / 192 - 451.0 / 720;
    case 4: return -2187.0 / 6784 - -12231.0 / 42400;
    case 5: return 11.0 / 84 - 649.0 / 6300;
    case 6: return -1.0 / 60.0;
    default: return 0.0;
  }
}

__host__ __device__ constexpr double c_mid_d(int j) {
  switch (j) {
    case 0: return 6025192743.0 / 30085553152.0 / 2;
    case 2: return 51252292925.0 / 65400821598.0 / 2;
    case 3: return -2691868925.0 / 45128329728.0 / 2;
    case 4: return 187940372067.0 / 1594534317056.0 / 2;
    case 5: return -1776094331.0 / 19743644256.0 / 2;
    case 6: return 11237099.0 / 235043384.0 / 2;
    default: return 0.0;
  }
}

// NaN-propagating max/min, as jnp.maximum / torch.maximum (fmaxf drops NaN).
__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a || b != b) ? (a + b) : fmaxf(a, b);
}
__device__ __forceinline__ float nmin(float a, float b) {
  return (a != a || b != b) ? (a + b) : fminf(a, b);
}

// ---- the GP field functor ----
// A is staged per block in shared memory as sA[(2m + d) * kBlock + lane],
// so a warp reads 32 consecutive words; the grid Z is shared by all chains.
struct GPField {
  const float* sA;
  const float* sZ;     // sZ[2m + d]
  int lane;
  float sf2;           // sf^2
  float inv2ell2;      // 1 / (2 ell^2)
  float invell2;       // 1 / ell^2

  __device__ __forceinline__ float a(int m, int d) const {
    return sA[(2 * m + d) * kBlock + lane];
  }

  // f = K(y, Z) A at the N points.
  __device__ __forceinline__ void rhs(const float* y, float* f) const {
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const float px = y[2 * n], py = y[2 * n + 1];
      float fx = 0.f, fy = 0.f;
#pragma unroll 4
      for (int m = 0; m < kM; ++m) {
        const float dx = px - sZ[2 * m];
        const float dy = py - sZ[2 * m + 1];
        const float K = sf2 * expf(-(dx * dx + dy * dy) * inv2ell2);
        fx += K * a(m, 0);
        fy += K * a(m, 1);
      }
      f[2 * n] = fx;
      f[2 * n + 1] = fy;
    }
  }

  // Vector-Jacobian product at y for the cotangent `cot` of f(y):
  // ybar = (d f / d y)^T cot, and Abar += (d f / d A)^T cot, accumulated
  // into this chain's column of sAbar.  Z gets no cotangent.
  __device__ __forceinline__ void rhs_vjp(const float* y, const float* cot,
                                          float* ybar, float* sAbar) const {
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const float px = y[2 * n], py = y[2 * n + 1];
      const float cx = cot[2 * n], cy = cot[2 * n + 1];
      float ubx = 0.f, uby = 0.f;
#pragma unroll 4
      for (int m = 0; m < kM; ++m) {
        const float dx = px - sZ[2 * m];
        const float dy = py - sZ[2 * m + 1];
        const float K = sf2 * expf(-(dx * dx + dy * dy) * inv2ell2);
        sAbar[(2 * m) * kBlock + lane] += K * cx;
        sAbar[(2 * m + 1) * kBlock + lane] += K * cy;
        const float adotc = a(m, 0) * cx + a(m, 1) * cy;
        const float w = K * adotc * invell2;
        ubx += w * (-dx);
        uby += w * (-dy);
      }
      ybar[2 * n] = ubx;
      ybar[2 * n + 1] = uby;
    }
  }
};

// Stage point r (0..5) of the step: y0 + dt * sum_j beta[r][j] k[j].
__device__ __forceinline__ void stage_point(int r, const float* y0,
                                            const float (*k)[kNS], float dt,
                                            float* out) {
#pragma unroll
  for (int i = 0; i < kNS; ++i) {
    float inc = 0.f;
    bool first = true;
#pragma unroll
    for (int j = 0; j <= 5; ++j) {
      if (j > r) break;
      const float b = static_cast<float>(beta_d(r, j));
      if (b != 0.f) {
        inc = first ? b * k[j][i] : inc + b * k[j][i];
        first = false;
      }
    }
    out[i] = y0[i] + dt * inc;
  }
}

// The six stages of one step from (y0, k[0] = f(y0)); fills k[1..6] and
// y1 (the last stage point, FSAL: k[6] = f(y1)).
template <class Field>
__device__ __forceinline__ void rk_stages(const Field& fld, const float* y0,
                                          float (*k)[kNS], float dt,
                                          float* y1) {
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    stage_point(r, y0, k, dt, y1);
    fld.rhs(y1, k[r + 1]);
  }
}

struct Decision {
  bool accept;
  float ratio;
  float dt_next;
  float err_next;
};

// Embedded error ratio (mean square over the 2N components with the
// 32-ulps tolerance floor) and the step controller: the memoryless "i"
// controller, or the Gustafsson PI.4.2 controller when pi is set.
__device__ __forceinline__ Decision step_decision(
    const float (*k)[kNS], const float* y0, const float* y1, float dt,
    float rtol, float atol, float safety, float ifactor, float dfactor,
    bool pi, float err_prev) {
  const float eps = 1.1920929e-07f;
  float sx = 0.f, sy = 0.f;
#pragma unroll
  for (int i = 0; i < kNS; ++i) {
    float acc = 0.f;
    bool first = true;
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      const float c = static_cast<float>(c_err_d(j));
      if (c != 0.f) {
        acc = first ? c * k[j][i] : acc + c * k[j][i];
        first = false;
      }
    }
    const float err = dt * acc;
    const float mag = nmax(fabsf(y0[i]), fabsf(y1[i]));
    const float tol = nmax(atol + rtol * mag, (32.0f * eps) * mag);
    const float r = err / tol;
    if (i % 2 == 0) sx += r * r; else sy += r * r;
  }
  Decision d;
  d.ratio = (sx + sy) / static_cast<float>(kNS);
  d.accept = d.ratio <= 1.0f;
  const float ratio = d.ratio;
  // the JAX kernels' norm floor float32(1e-38) is a subnormal that XLA
  // flushes to zero, so the floor here is 0
  const float err_nrm = sqrtf(nmax(ratio, 0.0f));
  const float dfac = ratio < 1.0f ? 1.0f : dfactor;
  float factor = nmax(1.0f / ifactor,
                      nmin(powf(err_nrm, 0.2f) / safety, 1.0f / dfac));
  if (!isfinite(factor)) factor = 1.0f / dfac;
  const float dt_i = dt / factor;
  if (!pi) {
    d.dt_next = ratio == 0.0f ? dt * ifactor : dt_i;
    d.err_next = err_prev;
    return d;
  }
  const float ep = nmax(err_prev, 0.0f);
  float factor_acc = safety * powf(err_nrm, -0.12f) * powf(ep, 0.04f);
  if (!isfinite(factor_acc)) factor_acc = dfactor;
  const float dt_acc = dt * nmin(nmax(factor_acc, dfactor), ifactor);
  float dt_next = d.accept ? dt_acc : dt_i;
  d.dt_next = ratio == 0.0f ? dt * ifactor : dt_next;
  d.err_next = d.accept ? err_nrm : err_prev;
  return d;
}

// y_mid = y0 + dt * sum_j c_mid[j] k[j].
__device__ __forceinline__ void midpoint(const float* y0,
                                         const float (*k)[kNS], float dt,
                                         float* ymid) {
#pragma unroll
  for (int i = 0; i < kNS; ++i) {
    float acc = 0.f;
    bool first = true;
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      const float c = static_cast<float>(c_mid_d(j));
      if (c != 0.f) {
        acc = first ? c * k[j][i] : acc + c * k[j][i];
        first = false;
      }
    }
    ymid[i] = y0[i] + dt * acc;
  }
}

// Dense-output quartic of one component evaluated at X (Horner form),
// coefficients as ode/interp.interp_fit.
__device__ __forceinline__ float quartic_eval(float y0, float y1, float ym,
                                              float f0, float f1, float dt,
                                              float X) {
  const float a = -2.0f * dt * f0 + 2.0f * dt * f1 - 8.0f * y0 - 8.0f * y1
                  + 16.0f * ym;
  const float b = 5.0f * dt * f0 - 3.0f * dt * f1 + 18.0f * y0 + 14.0f * y1
                  - 32.0f * ym;
  const float c = -4.0f * dt * f0 + dt * f1 - 11.0f * y0 - 5.0f * y1
                  + 16.0f * ym;
  const float d = dt * f0;
  return (((a * X + b) * X + c) * X + d) * X + y0;
}

// Stage this block's A rows (C, M, 2) into sA with coalesced loads; chains
// past C read as zero.  Z is copied once per block.
__device__ __forceinline__ void stage_weights(const float* __restrict__ A,
                                              const float* __restrict__ Z,
                                              int C, float* sA, float* sZ) {
  const int c0 = blockIdx.x * kBlock;
  for (int idx = threadIdx.x; idx < kBlock * 2 * kM; idx += kBlock) {
    const int l = idx / (2 * kM);
    const int j = idx - l * (2 * kM);
    sA[j * kBlock + l] =
        (c0 + l < C) ? A[static_cast<size_t>(c0) * 2 * kM + idx] : 0.f;
  }
  for (int idx = threadIdx.x; idx < 2 * kM; idx += kBlock) sZ[idx] = Z[idx];
}

}  // namespace bode
