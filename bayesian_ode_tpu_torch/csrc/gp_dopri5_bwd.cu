// Frozen-step-mesh discrete adjoint of the whole adaptive solve of the GP
// field, one thread per trajectory point: the backward kernel of
// dopri5_kernels.cuh over GPReplayPoint (gp_field.cuh: GPPoint<8>, or
// GPWidePoint past N = 32 or an inducing grid whose Abar columns pass a
// block's shared memory, gp_wide_field.cuh: then one Abar column a chain,
// its points' shares summed by shuffles at each term).
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
// What bounds it on an H100: the throughput of the field's FP32 and expf work
// (7 evaluations and 7 VJPs of M kernel values a point and step), with
// latency to hide.  The replay never mixes the N points' rows (the TPU
// kernel stacks them in sublanes), so each point's sweep is a thread of
// its own: at 10,112 chains and N = 5 that is 1,686 warps (12.8 an SM)
// where one chain per thread gave 316, and each thread's serial chain of
// expf and FMAs is N times shorter.  A warp waits for the longest record
// count of its 6 chains.  Each thread keeps its point's Abar, for 8
// inducing points in registers and for the rest in its own column of
// shared memory (GPReplayPoint); the N partials of a chain are summed by
// warp shuffles at the end, with no atomics, so gradients are
// deterministic.  x0bar is returned per chain;
// the sum over chains is done outside.
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
  const bode::GPReplayPoint::Args w{A, Z, sf2, inv2ell2, invell2};
  const bode::GPReplayPoint::Grads gw{Abar};
  return bode::launch_bwd<bode::GPReplayPoint>(tableau, w, gw, ts, rec, nrec,
                                               g, C, T, lbar, stream);
}

// The shared memory of a block of the backward at DOPRI5 and at TSIT5,
// static and dynamic: the shape check's arithmetic (ops/_build.py) against
// the build.
int gp_dopri5_bwd_smem(int* bytes) {
  return bode::bwd_smem<bode::GPReplayPoint>(bytes);
}

}  // extern "C"
