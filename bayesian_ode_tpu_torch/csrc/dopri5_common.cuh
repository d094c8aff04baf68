// Shared device code of the fused adaptive kernels (Hopper, sm_90a): the
// step arithmetic of a 7-stage FSAL pair with quartic dense output.
//
// The step arithmetic lives here once, as in the JAX package's
// ops/gp_dopri5.py (_rk_stages, _step_decision, _quartic_coeffs,
// _midpoint), generic over
//   NS       the state components a thread carries: a chain's 2N floats
//            y[2n + d], or its share where the field spreads the state
//            (field_stages.cuh: then only step_decision's error norm
//            reaches across threads, through the field's norm_sums);
//   Tableau  Dopri5 or Tsit5 below: constexpr beta, c_err and c_mid;
//   Field    a functor with rhs(const float* y, float* f) const.
// The kernels of dopri5_kernels.cuh are its only users, so the
// non-recording whole solve (K1) and the recording forward (K2) produce
// the same trajectories bit for bit, and the per-step solver (K9) takes
// the same steps.  Full float32 throughout: built
// without --use_fast_math and with expf/tanhf, because reduced-precision
// right-hand sides shrink adaptive step sizes.
//
// Sums skip the zero coefficients and add the others in stage order,
// starting from the first nonzero product: the order of the JAX helpers'
// `sum(b * k for b, k in zip(row, k) if b != 0)` for both tableaus
// (every TSIT5 coefficient is nonzero, so there it is the plain order).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "field_stages.cuh"

namespace bode {

// ---- Dormand-Prince 5(4) (ode/tableaus.py DOPRI5) ----
struct Dopri5 {
  static constexpr int kOrder = 5;

  __host__ __device__ static constexpr double beta(int r, int j) {
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

  __host__ __device__ static constexpr double c_err(int j) {
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

  __host__ __device__ static constexpr double c_mid(int j) {
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
};

// ---- Tsitouras 5(4) (ode/tableaus.py TSIT5), with the corrected c_error
// row and the derived c_mid of the JAX package ----
struct Tsit5 {
  static constexpr int kOrder = 5;

  __host__ __device__ static constexpr double beta(int r, int j) {
    switch (r * 8 + j) {
      case 0: return 0.161;
      case 8: return -0.008480655492357;
      case 9: return 0.3354806554923570;
      case 16: return 2.897153057105494;
      case 17: return -6.359448489975075;
      case 18: return 4.362295432869581;
      case 24: return 5.32586482843925895;
      case 25: return -11.74888356406283;
      case 26: return 7.495539342889836;
      case 27: return -0.09249506636175525;
      case 32: return 5.86145544294642038;
      case 33: return -12.92096931784711;
      case 34: return 8.159367898576159;
      case 35: return -0.071584973281401006;
      case 36: return -0.02826905039406838;
      case 40: return 0.09646076681806523;
      case 41: return 0.01;
      case 42: return 0.4798896504144996;
      case 43: return 1.379008574103742;
      case 44: return -3.290069515436081;
      case 45: return 2.324710524099774;
      default: return 0.0;
    }
  }

  __host__ __device__ static constexpr double c_err(int j) {
    switch (j) {
      case 0: return 0.00178001105222577714;
      case 1: return 0.0008164344596567469;
      case 2: return -0.007880878010261995;
      case 3: return 0.1447110071732629;
      case 4: return -0.5823571654525552;
      case 5: return 0.4580821059291869;
      case 6: return -1.0 / 66;
      default: return 0.0;
    }
  }

  __host__ __device__ static constexpr double c_mid(int j) {
    switch (j) {
      case 0: return 0.11142574892073395;
      case 1: return 0.013197067390738587;
      case 2: return 0.37783998967297555;
      case 3: return -0.018471772229541692;
      case 4: return 0.0031427990704557002;
      case 5: return 0.01577833690800391;
      case 6: return -0.0029121697333658932;
      default: return 0.0;
    }
  }
};

// NaN-propagating max/min, as jnp.maximum / torch.maximum (fmaxf drops NaN).
__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a || b != b) ? (a + b) : fmaxf(a, b);
}
__device__ __forceinline__ float nmin(float a, float b) {
  return (a != a || b != b) ? (a + b) : fminf(a, b);
}

// Stage point r (0..5) of the step: y0 + dt * sum_j beta[r][j] k[j].
template <int NS, class TB>
__device__ __forceinline__ void stage_point(int r, const float* y0,
                                            const float (*k)[NS], float dt,
                                            float* out) {
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    float inc = 0.f;
    bool first = true;
#pragma unroll
    for (int j = 0; j <= 5; ++j) {
      if (j > r) break;
      const float b = static_cast<float>(TB::beta(r, j));
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
template <int NS, class TB, class Field>
__device__ __forceinline__ void rk_stages(const Field& fld, const float* y0,
                                          float (*k)[NS], float dt,
                                          float* y1) {
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    stage_point<NS, TB>(r, y0, k, dt, y1);
    fld.rhs(y1, k[r + 1]);
  }
}

struct Decision {
  bool accept;
  float ratio;
  float dt_next;
  float err_next;
};

// Embedded error ratio (mean square over the chain's 2N components with
// the 32-ulps tolerance floor) and the step controller: the memoryless "i"
// controller, or the Gustafsson PI.4.2 controller when pi is set.  The
// squared ratios are summed over the x components and the y components
// apart, each in ascending n: on one thread, or by the field's norm_sums
// where it spreads the state.
template <int NS, class TB, class Field>
__device__ __forceinline__ Decision step_decision(
    const Field& fld, const float (*k)[NS], const float* y0, const float* y1,
    float dt, float rtol, float atol, float safety, float ifactor,
    float dfactor, bool pi, float err_prev) {
  // the controller exponents below are 1/5, -0.6/5 and 0.2/5
  static_assert(TB::kOrder == 5, "controller exponents assume order 5");
  const float eps = 1.1920929e-07f;
  float r[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    float acc = 0.f;
    bool first = true;
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      const float c = static_cast<float>(TB::c_err(j));
      if (c != 0.f) {
        acc = first ? c * k[j][i] : acc + c * k[j][i];
        first = false;
      }
    }
    const float err = dt * acc;
    const float mag = nmax(fabsf(y0[i]), fabsf(y1[i]));
    const float tol = nmax(atol + rtol * mag, (32.0f * eps) * mag);
    r[i] = err / tol;
  }
  float sx = 0.f, sy = 0.f;
  if constexpr (spreads_forward<Field>::value) {
    fld.norm_sums(r, sx, sy);
  } else {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      if (i % 2 == 0) sx += r[i] * r[i]; else sy += r[i] * r[i];
    }
  }
  Decision d;
  d.ratio = (sx + sy) / static_cast<float>(Field::kNS);
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
template <int NS, class TB>
__device__ __forceinline__ void midpoint(const float* y0,
                                         const float (*k)[NS], float dt,
                                         float* ymid) {
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    float acc = 0.f;
    bool first = true;
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      const float c = static_cast<float>(TB::c_mid(j));
      if (c != 0.f) {
        acc = first ? c * k[j][i] : acc + c * k[j][i];
        first = false;
      }
    }
    ymid[i] = y0[i] + dt * acc;
  }
}

// Dense-output quartic fit of one component (ode/interp.interp_fit),
// highest-order coefficient first: cf = (a, b, c, d, e).
__device__ __forceinline__ void quartic_coeffs(float y0, float y1, float ym,
                                               float f0, float f1, float dt,
                                               float* cf) {
  cf[0] = -2.0f * dt * f0 + 2.0f * dt * f1 - 8.0f * y0 - 8.0f * y1
          + 16.0f * ym;
  cf[1] = 5.0f * dt * f0 - 3.0f * dt * f1 + 18.0f * y0 + 14.0f * y1
          - 32.0f * ym;
  cf[2] = -4.0f * dt * f0 + dt * f1 - 11.0f * y0 - 5.0f * y1 + 16.0f * ym;
  cf[3] = dt * f0;
  cf[4] = y0;
}

// The quartic of one component evaluated at X (Horner form).
__device__ __forceinline__ float quartic_eval(float y0, float y1, float ym,
                                              float f0, float f1, float dt,
                                              float X) {
  float cf[5];
  quartic_coeffs(y0, y1, ym, f0, f1, dt, cf);
  return (((cf[0] * X + cf[1]) * X + cf[2]) * X + cf[3]) * X + cf[4];
}

}  // namespace bode
