// Whole adaptive solve of the spiral y^3-net field, one warp per chain:
// the forward kernels of dopri5_kernels.cuh over SpiralDopri5
// (spiral_field.cuh, which says why a warp and not a thread per chain).
//
// Replaces bayesian_ode_tpu/ops/fused_adaptive.py::make_fwd_rec_kernel (K2)
// as bayesian_ode_tpu/ops/spiral_dopri5.py registers the spiral field on
// the public engine (record = 1), and the same solve without records
// (record = 0).
//
// What bounds it on an H100: tanhf, and the shuffles that sum and
// broadcast f.  A field evaluation at one point is H tanhf and 4H FMAs
// over the warp (2 unit slots a lane at H=50); the 2N sums of an
// evaluation are one 16-wide reduce-scatter, broadcast back to every lane
// by 2N shuffles, so every lane takes the same step decisions; a step is
// 6 x N such points.  The weights are read once per chain into registers;
// lane 0 alone writes the dense output and records.
#include "dopri5_kernels.cuh"
#include "spiral_field.cuh"

extern "C" {

// Dimensions this library was built for.
int spiral_dopri5_dims(int* n_points, int* hidden) {
  *n_points = bode::kSN;
  *hidden = bode::kSH;
  return 0;
}

// w1 (C, 2, H), b1 (C, H), w2 (C, H, 2), b2 (C, 2); the rest as
// gp_dopri5_fwd.  Returns cudaGetLastError().
int spiral_dopri5_fwd(int record, int tableau, const float* w1,
                      const float* b1, const float* w2, const float* b2,
                      const float* x0, const float* f0, const float* dt0,
                      const float* ts, int C, int T, float rtol, float atol,
                      float safety, float ifactor, float dfactor,
                      int max_steps, int pi, int store_steps, float* ys,
                      int* nfe, int* nacc, int* nrej, float* t1, float* rec,
                      cudaStream_t stream) {
  const bode::SpiralDopri5::Args w{w1, b1, w2, b2};
  const bode::SolveArgs s{rtol, atol, safety, ifactor, dfactor, max_steps,
                          pi, record ? store_steps : 0};
  const bode::FwdOut o{ys, nfe, nacc, nrej, t1, record ? rec : nullptr};
  return bode::launch_fwd<bode::SpiralDopri5>(record, tableau, w, x0, f0,
                                              dt0, ts, C, T, s, o, stream);
}

// The shared memory of a block of each forward (DOPRI5 and TSIT5, each
// without and with records), static and dynamic: the shape check's
// arithmetic (ops/_build.py) against the build.
int spiral_dopri5_fwd_smem(int* bytes) {
  return bode::fwd_smem<bode::SpiralDopri5>(bytes);
}

}  // extern "C"
