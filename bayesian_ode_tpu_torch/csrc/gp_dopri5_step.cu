// The per-step dopri5 solver of the GP field, one trajectory point a
// thread: dopri5_step_kernel of dopri5_kernels.cuh over GPFwdPoint
// (gp_field.cuh: GPPoint<8>, or GPWidePoint where that does not fit; the
// field of the whole solve K1, so the two take the same steps).
//
// Replaces bayesian_ode_tpu/ops/gp_dopri5.py::_make_kernel (K9) and the
// lax.while_loop that `gp_dopri5_solve` runs around it per output
// interval.  One launch takes every chain to ts[k], up to a cap of
// iterations (the step budget left, which is collective), and writes each
// chain's dense output there, so a solve is one launch per output interval
// while the budget does not bind.  `flags` tells the host whether a chain
// is still short of ts[k] and the most steps any chain has taken.
// gp_dopri5_intervals issues the launches of all intervals at once, each
// reading its cap from the previous one's flags, and the host reads all
// the flags once a solve; gp_dopri5_interval is one launch, for the host
// loop that launches an interval again where a chain was left short with
// budget left.
//
// What bounds it on an H100: the same expf work per attempted step as K1
// (6 x N x M = 1,080 at N=5, M=36), split over T - 1 launches, plus each
// launch's host cost (a launch, its flags' read); the chains of a launch
// wait for the slowest one at its output time.  The state moves through
// device memory between launches (about 100 floats a chain), far below
// either.
#include "dopri5_kernels.cuh"
#include "gp_field.cuh"

extern "C" {

// Dimensions this library was built for.
int gp_dopri5_step_dims(int* n_points, int* n_inducing) {
  *n_points = bode::kN;
  *n_inducing = bode::kM;
  return 0;
}

// A (C, M, 2), Z (M, 2), ts (T,); the state y, f (C, N, 2), t0, t1, dt
// (C,), coef (5, C, N, 2), nfe/nacc/nrej (C,) int32, updated in place;
// flags (2,) int32, written; ys (T, C, N, 2), row k written.  Steps every
// chain with t1 < ts[k] at most `cap` times, then writes its dense output
// at ts[k].  Returns cudaGetLastError().
int gp_dopri5_interval(const float* A, const float* Z, float sf2,
                       float inv2ell2, float invell2, const float* ts, int k,
                       int C, int cap, float rtol, float atol, float safety,
                       float ifactor, float dfactor, float* y, float* f,
                       float* t0, float* t1, float* dt, float* coef, int* nfe,
                       int* nacc, int* nrej, int* flags, float* ys,
                       cudaStream_t stream) {
  const bode::GPFwdPoint::Args w{A, Z, sf2, inv2ell2, invell2};
  const bode::SolveArgs s{rtol, atol, safety, ifactor, dfactor, 0, 0, 0};
  const bode::StepState st{y, f, t0, t1, dt, coef, nfe, nacc, nrej, flags};
  return bode::launch_step<bode::GPFwdPoint>(w, ts, k, C, cap, s, st, ys,
                                                stream);
}

// The launches of gp_dopri5_interval for k = 1..T-1 at once, each with the
// cap the host would give it after the previous one (the budget left of
// max_steps, rounded up to steps_per_call), read on the device; flags
// (T, 2) int32, row k written by interval k's launch.  Returns the first
// launch error, or 0.
int gp_dopri5_intervals(const float* A, const float* Z, float sf2,
                        float inv2ell2, float invell2, const float* ts, int T,
                        int C, int max_steps, int steps_per_call, float rtol,
                        float atol, float safety, float ifactor,
                        float dfactor, float* y, float* f, float* t0,
                        float* t1, float* dt, float* coef, int* nfe,
                        int* nacc, int* nrej, int* flags, float* ys,
                        cudaStream_t stream) {
  const bode::GPFwdPoint::Args w{A, Z, sf2, inv2ell2, invell2};
  const bode::SolveArgs s{rtol, atol, safety, ifactor, dfactor, 0, 0, 0};
  const bode::StepState st{y, f, t0, t1, dt, coef, nfe, nacc, nrej, flags};
  return bode::launch_steps<bode::GPFwdPoint>(
      w, ts, T, C, max_steps, steps_per_call, s, st, ys, stream);
}

// The shared memory of a block of the per-step solver, static and
// dynamic: the shape check's arithmetic (ops/_build.py) against the build.
int gp_dopri5_step_smem(int* bytes) {
  return bode::step_smem<bode::GPFwdPoint>(bytes);
}

}  // extern "C"
