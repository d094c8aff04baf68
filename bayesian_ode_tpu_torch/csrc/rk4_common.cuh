// Shared device code of the fused fixed-grid rk4 kernels (Hopper, sm_90a).
//
// One 3/8-rule step and its transpose, generic over a field functor with
//   rhs(const float* y, float* f) const
//   rhs_vjp(const float* y, const float* cot, float* ybar, Acc acc) const
// (ybar = (df/dy)^T cot; the weight cotangent is accumulated into `acc`,
// whatever the field keeps it in), and the stage slots of field_stages.cuh
// in the transpose: slot 0 is the step's start p, slots 1-3 its stage
// points u2, u3, u4.  NS is the number of a chain's state components a
// thread carries: all 2N of them, or, in the MLP field's transpose, the
// one component i that lane i carries.
// The GP field (gp_field.cuh, gp_rk4.cu: K4/K5) and the MLP field
// (mlp_field.cuh, mlp_rk4.cu: K6/K7) are its instances.
//
// The operation order is that of the TPU kernels
// (bayesian_ode_tpu/ops/gp_rk4.py and mlp_rk4.py): the stage points
// p + dt/3 k1, p + dt (-k1/3 + k2), p + dt (k1 - k2 + k3), the update
// p + dt/8 (k1 + 3 k2 + 3 k3 + k4), and the reverse sweep's coefficients,
// so the plain PyTorch versions in ops/gp_rk4.py and ops/mlp_rk4.py
// compute the same sums in the same order.
#pragma once

#include <cuda_runtime.h>

#include "field_stages.cuh"

namespace bode {

// The three inner stage points of the step from p, with the field
// evaluated as eval(slot, y, f); k1..k3 are returned too, for the
// forward's update.
template <int NS, class Eval>
__device__ __forceinline__ void rk4_stage_points(Eval&& eval,
                                                 const float* p, float dt,
                                                 float* k1, float* k2,
                                                 float* k3, float* u2,
                                                 float* u3, float* u4) {
  eval(0, p, k1);
#pragma unroll
  for (int i = 0; i < NS; ++i) u2[i] = p[i] + dt / 3.0f * k1[i];
  eval(1, u2, k2);
#pragma unroll
  for (int i = 0; i < NS; ++i) u3[i] = p[i] + dt * (-k1[i] / 3.0f + k2[i]);
  eval(2, u3, k3);
#pragma unroll
  for (int i = 0; i < NS; ++i) u4[i] = p[i] + dt * (k1[i] - k2[i] + k3[i]);
}

// One 3/8-rule step: out = p + dt/8 (k1 + 3 k2 + 3 k3 + k4).
template <int NS, class Field>
__device__ __forceinline__ void rk4_step(const Field& fld, const float* p,
                                         float dt, float* out) {
  float k1[NS], k2[NS], k3[NS], u2[NS], u3[NS], u4[NS], k4[NS];
  rk4_stage_points<NS>(
      [&](int, const float* y, float* f) { fld.rhs(y, f); }, p, dt, k1, k2,
      k3, u2, u3, u4);
  fld.rhs(u4, k4);
#pragma unroll
  for (int i = 0; i < NS; ++i)
    out[i] = p[i] + dt / 8.0f * (k1[i] + 3.0f * k2[i] + 3.0f * k3[i] + k4[i]);
}

// Transpose of one step from p, with the four stages recomputed: on entry
// l is the cotangent of the step's end point, on return that of p.  The
// weight cotangent of the four field evaluations goes to `acc`.
template <int NS, class Field, class Acc>
__device__ __forceinline__ void rk4_step_vjp(const Field& fld,
                                             const float* p, float dt,
                                             float* l, Acc&& acc) {
  float u2[NS], u3[NS], u4[NS];
  {
    float k1[NS], k2[NS], k3[NS];
    rk4_stage_points<NS>(
        [&](int slot, const float* y, float* f) {
          stage_rhs(fld, slot, y, f);
        },
        p, dt, k1, k2, k3, u2, u3, u4);
  }
  stage_hidden(fld, 3, u4);
  // reverse of: next = p + dt/8 (k1 + 3 k2 + 3 k3 + k4)
  float pb[NS], kb1[NS], kb2[NS], kb3[NS], kb4[NS], ub[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    pb[i] = l[i];
    kb1[i] = dt / 8.0f * l[i];
    kb2[i] = 3.0f * dt / 8.0f * l[i];
    kb3[i] = 3.0f * dt / 8.0f * l[i];
    kb4[i] = dt / 8.0f * l[i];
  }
  // k4 = f(u4), u4 = p + dt (k1 - k2 + k3)
  stage_vjp(fld, 3, u4, kb4, ub, acc);
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    pb[i] += ub[i];
    kb1[i] += dt * ub[i];
    kb2[i] += -dt * ub[i];
    kb3[i] += dt * ub[i];
  }
  // k3 = f(u3), u3 = p + dt (-k1/3 + k2)
  stage_vjp(fld, 2, u3, kb3, ub, acc);
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    pb[i] += ub[i];
    kb1[i] += -dt / 3.0f * ub[i];
    kb2[i] += dt * ub[i];
  }
  // k2 = f(u2), u2 = p + dt/3 k1
  stage_vjp(fld, 1, u2, kb2, ub, acc);
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    pb[i] += ub[i];
    kb1[i] += dt / 3.0f * ub[i];
  }
  // k1 = f(p)
  stage_vjp(fld, 0, p, kb1, ub, acc);
#pragma unroll
  for (int i = 0; i < NS; ++i) l[i] = pb[i] + ub[i];
}

}  // namespace bode
