// The per-step dopri5 solver of the GP field, one chain per thread:
// dopri5_step_kernel of dopri5_kernels.cuh over GPDopri5 (gp_field.cuh).
//
// Replaces bayesian_ode_tpu/ops/gp_dopri5.py::_make_kernel (K9), which
// `gp_dopri5_solve` launches from a host loop per output interval.  Each
// launch takes up to `steps` masked steps of every chain short of ts[k],
// with the step arithmetic of the whole-solve kernel K1, and leaves in
// `flags` what the host loop needs to decide whether to launch again (any
// chain still short of ts[k], the most steps taken): one small read per
// launch.
//
// What bounds it on an H100: the same expf work per attempted step as K1
// (6 x N x M = 1,080 at N=5, M=36), plus the host loop: the chains wait
// for the slowest one at every output time, and every launch ends with a
// device-to-host read.  The state moves through device memory between
// launches (about 100 floats a chain), far below either.
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
// flags (2,) int32, written.  Steps every chain with t1 < ts[k] up to
// `steps` times.  Returns cudaGetLastError().
int gp_dopri5_step(const float* A, const float* Z, float sf2, float inv2ell2,
                   float invell2, const float* ts, int k, int T, int C,
                   int steps, float rtol, float atol, float safety,
                   float ifactor, float dfactor, float* y, float* f,
                   float* t0, float* t1, float* dt, float* coef, int* nfe,
                   int* nacc, int* nrej, int* flags, cudaStream_t stream) {
  const bode::GPDopri5::Args w{A, Z, sf2, inv2ell2, invell2};
  const bode::SolveArgs s{rtol, atol, safety, ifactor, dfactor, 0, 0, 0};
  const bode::StepState st{y, f, t0, t1, dt, coef, nfe, nacc, nrej, flags};
  return bode::launch_step<bode::GPDopri5>(w, ts, k, T, C, steps, s, st,
                                           stream);
}

// The shared memory of a block of the per-step solver, static and
// dynamic: the shape check's arithmetic (ops/_build.py) against the build.
int gp_dopri5_step_smem(int* bytes) {
  return bode::step_smem<bode::GPDopri5>(bytes);
}

}  // extern "C"
