// Whole adaptive solve of the GP field, one thread per trajectory point:
// the forward kernels of dopri5_kernels.cuh over GPFwdPoint
// (gp_field.cuh: GPPoint, or GPWidePoint past N = 32 or where GPPoint's
// block passes a block's shared memory, gp_wide_field.cuh).
//
// Replaces, over the GP field, two TPU kernels with one template:
//   record = 0: bayesian_ode_tpu/ops/gp_dopri5.py::_make_whole_kernel (K1,
//               the non-recording whole solve);
//   record = 1: bayesian_ode_tpu/ops/fused_adaptive.py::make_fwd_rec_kernel
//               (K2, the forward that records the step mesh), as
//               ops/gp_dopri5_grad.py and ops/gp_field.py instantiate it.
//
// What bounds it on an H100: the instruction throughput of the field's
// FP32 and expf work, with latency to hide, not bytes.  Per attempted step
// a chain evaluates 6 x N x M = 1,080 expf at N=5, M=36, about 49 steps in
// sequence, and reads only its own state; the chain's A (M float2
// columns) and the grid Z sit in shared memory, so device memory sees only
// the dense output and the record rows.  One chain a thread left 316
// warps at 10,112 chains (2-4 an SM) to hide the latency of a serial chain
// of expf and FMAs; one point a thread, N consecutive lanes a chain, gives
// 1,686 warps (12.8 an SM, 422 blocks of 128 threads, all resident at
// once) with each thread's chain N times shorter.  The only chain-wide
// step, the error norm, is a gather of the N points' ratios by shuffles,
// summed in the per-chain order, so the trajectories, counters and
// records are the per-chain solve's bit for bit.
#include "dopri5_kernels.cuh"
#include "gp_field.cuh"

extern "C" {

// Dimensions this library was built for.
int gp_dopri5_dims(int* n_points, int* n_inducing) {
  *n_points = bode::kN;
  *n_inducing = bode::kM;
  return 0;
}

// A (C, M, 2), Z (M, 2), x0 (N, 2) shared, f0 (C, N, 2), dt0 (C,), ts
// (T,); ys (T, C, N, 2); nfe/nacc/nrej (C,) int32; t1 (C,); rec
// (store_steps, 2N + 2, C) when record != 0.  tableau 0 is DOPRI5, 1 TSIT5.
// Returns cudaGetLastError().
int gp_dopri5_fwd(int record, int tableau, const float* A, const float* Z,
                  float sf2, float inv2ell2, float invell2, const float* x0,
                  const float* f0, const float* dt0, const float* ts, int C,
                  int T, float rtol, float atol, float safety, float ifactor,
                  float dfactor, int max_steps, int pi, int store_steps,
                  float* ys, int* nfe, int* nacc, int* nrej, float* t1,
                  float* rec, cudaStream_t stream) {
  const bode::GPFwdPoint::Args w{A, Z, sf2, inv2ell2, invell2};
  const bode::SolveArgs s{rtol, atol, safety, ifactor, dfactor, max_steps,
                          pi, record ? store_steps : 0};
  const bode::FwdOut o{ys, nfe, nacc, nrej, t1, record ? rec : nullptr};
  return bode::launch_fwd<bode::GPFwdPoint>(record, tableau, w, x0, f0,
                                               dt0, ts, C, T, s, o, stream);
}

// The shared memory of a block of each forward (DOPRI5 and TSIT5, each
// without and with records), static and dynamic: the shape check's
// arithmetic (ops/_build.py) against the build.
int gp_dopri5_fwd_smem(int* bytes) {
  return bode::fwd_smem<bode::GPFwdPoint>(bytes);
}

}  // extern "C"
