// Whole adaptive solve of the MLP field 2 -> H -> H -> 2, one warp per
// chain and one state component a lane: the forward kernels of
// dopri5_kernels.cuh over MLPDopri5Fwd (mlp_field.cuh).
//
// Replaces bayesian_ode_tpu/ops/fused_adaptive.py::make_fwd_rec_kernel (K2)
// as bayesian_ode_tpu/ops/mlp_dopri5.py registers the MLP field on the
// public engine (record = 1), and the same solve without records (the
// engine's stats path, record = 0).
//
// What bounds it on an H100: the MIO pipe and the FP32 FMAs.  A field
// evaluation at N points gathers the point (lane i holds component i)
// through the warp's shared copy, runs a hidden pass through the shared
// copy of h1 with W2's column in the lane's registers (mlp_field.cuh),
// 2NH expf over the warp, and one 16-wide reduce-scatter that leaves f_i
// on lane i; a step is 6 such evaluations.  The step arithmetic runs once
// a component, on its lane.  The error norm is gathered from lanes
// 0..2N-1 by 2N shuffles and summed in the per-chain order
// (MLPDopri5Fwd::norm_sums), so the while loop is warp-uniform and takes
// the steps of one chain's loop, bit for bit.  Lanes 0..2N-1 write the
// dense output and records.
// Past H = 32 or N = 16 the same templates run over mlp_wide_field.cuh's
// MLPDopri5Fwd and MLPDopri5 (one warp and block a chain, W2 in the
// warp's buffer in dynamic shared memory).
#include "dopri5_kernels.cuh"
#include "mlp_field.cuh"

extern "C" {

// Dimensions this library was built for.
int mlp_dopri5_dims(int* n_points, int* hidden) {
  *n_points = bode::kMN;
  *hidden = bode::kH;
  return 0;
}

// The layer list w1 (C, 2, H), b1 (C, H), w2 (C, H, H), b2 (C, H),
// w3 (C, H, 2), b3 (C, 2); the rest as gp_dopri5_fwd.  Returns
// cudaGetLastError().
int mlp_dopri5_fwd(int record, int tableau, const float* w1, const float* b1,
                   const float* w2, const float* b2, const float* w3,
                   const float* b3, const float* x0, const float* f0,
                   const float* dt0, const float* ts, int C, int T,
                   float rtol, float atol, float safety, float ifactor,
                   float dfactor, int max_steps, int pi, int store_steps,
                   float* ys, int* nfe, int* nacc, int* nrej, float* t1,
                   float* rec, cudaStream_t stream) {
  const bode::MLPDopri5Fwd::Args w{w1, b1, w2, b2, w3, b3};
  const bode::SolveArgs s{rtol, atol, safety, ifactor, dfactor, max_steps,
                          pi, record ? store_steps : 0};
  const bode::FwdOut o{ys, nfe, nacc, nrej, t1, record ? rec : nullptr};
  return bode::launch_fwd<bode::MLPDopri5Fwd>(record, tableau, w, x0, f0,
                                              dt0, ts, C, T, s, o, stream);
}

// The shared memory of a block of each forward (DOPRI5 and TSIT5, each
// without and with records), static and dynamic: the shape check's
// arithmetic (ops/_build.py) against the build.
int mlp_dopri5_fwd_smem(int* bytes) {
  return bode::fwd_smem<bode::MLPDopri5Fwd>(bytes);
}

}  // extern "C"
