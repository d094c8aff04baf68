// Whole adaptive solve of the spiral y^3-net field, one warp per chain and
// one state component a lane: the forward kernels of dopri5_kernels.cuh
// over SpiralDopri5Fwd (spiral_field.cuh, which says why a warp and not a
// thread per chain).
//
// Replaces bayesian_ode_tpu/ops/fused_adaptive.py::make_fwd_rec_kernel (K2)
// as bayesian_ode_tpu/ops/spiral_dopri5.py registers the spiral field on
// the public engine (record = 1), and the same solve without records
// (record = 0).
//
// What bounds it on an H100: tanhf, and the serial latency of a chain's
// steps.  A field evaluation at one point is H tanhf and 4H FMAs over the
// warp (2 unit slots a lane at H=50), and a step is 6 x N such points.
// Lane i carries component i of the state, the stages and the dense
// output, so the step arithmetic is done once per component, not once per
// lane; an evaluation gathers the point through the warp's 48 B buffer
// and leaves f_i on lane i (the 16-wide reduce-scatter), with no
// broadcast back.  The error norm gathers the 2N ratios by shuffles and
// sums them in the per-chain order, so every lane takes the same step
// decision and the solves are bit-equal to a design that keeps the whole
// state on every lane.  Few registers a lane (SpiralDopri5Fwd::kMinBlocks:
// 32 warps an SM) leave the latency of the serial chain to other warps.
// The weights are read once per chain into registers.
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
  const bode::SpiralDopri5Fwd::Args w{w1, b1, w2, b2};
  const bode::SolveArgs s{rtol, atol, safety, ifactor, dfactor, max_steps,
                          pi, record ? store_steps : 0};
  const bode::FwdOut o{ys, nfe, nacc, nrej, t1, record ? rec : nullptr};
  return bode::launch_fwd<bode::SpiralDopri5Fwd>(record, tableau, w, x0, f0,
                                                 dt0, ts, C, T, s, o,
                                                 stream);
}

// The shared memory of a block of each forward (DOPRI5 and TSIT5, each
// without and with records), static and dynamic: the shape check's
// arithmetic (ops/_build.py) against the build.
int spiral_dopri5_fwd_smem(int* bytes) {
  return bode::fwd_smem<bode::SpiralDopri5Fwd>(bytes);
}

}  // extern "C"
