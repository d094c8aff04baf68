// Frozen-step-mesh discrete adjoint of the whole adaptive solve of the GP
// field, one chain per thread: the backward kernel of dopri5_kernels.cuh
// over GPDopri5 (gp_field.cuh).
//
// Replaces bayesian_ode_tpu/ops/fused_adaptive.py::make_bwd_kernel (K3)
// over the GP field VJP of bayesian_ode_tpu/ops/gp_dopri5_grad.py::
// _make_rhs_vjp.  Per recorded (accepted) step, in reverse: recompute the
// 7 stage derivatives from the stored start state; pull the cotangents of
// the output times the step emitted back through the Horner evaluation and
// the quartic-coefficient map; through y_mid = y0 + dt (c_mid . k); and
// through the transposed stage recurrence, calling the field VJP at each
// stage point and accumulating Abar.  Step sizes are constants.
//
// What bounds it on an H100: latency.  A step costs 7 field evaluations
// plus 7 VJPs (each N x M expf) and keeps 6 stage points and 7 stage
// cotangents live (13 x 2N floats) in registers.  At 10,112 chains the 158
// blocks of 64 give most SMs one block: each thread's serial chain of expf
// and FMAs sets the time.  Abar is accumulated per chain in shared memory
// and written once, with no atomics, so gradients are deterministic.
// x0bar is returned per chain; the sum over chains is done outside.
#include "dopri5_kernels.cuh"
#include "gp_field.cuh"

extern "C" {

// Abar (C, M, 2) and lbar (C, N, 2), the per-chain x0 cotangent, from the
// records of gp_dopri5_fwd(record=1), their counts nrec (C,) int32 and the
// trajectory cotangent g (T, C, N, 2).  Returns cudaGetLastError().
int gp_dopri5_bwd(int tableau, const float* A, const float* Z, float sf2,
                  float inv2ell2, float invell2, float* Abar,
                  const float* ts, const float* rec, const int* nrec,
                  const float* g, int C, int T, float* lbar,
                  cudaStream_t stream) {
  const bode::GPDopri5::Args w{A, Z, sf2, inv2ell2, invell2};
  const bode::GPDopri5::Grads gw{Abar};
  return bode::launch_bwd<bode::GPDopri5>(tableau, w, gw, ts, rec, nrec, g,
                                          C, T, lbar, stream);
}

}  // extern "C"
