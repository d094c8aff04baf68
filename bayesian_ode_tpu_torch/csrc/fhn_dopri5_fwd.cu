// Whole adaptive solve of the FitzHugh-Nagumo theta-field, one trajectory
// point a thread: the forward kernels of dopri5_kernels.cuh over FHNFwd
// (fhn_field.cuh: FHNPoint, or FHNDopri5 past 32 points a chain).
//
// Replaces bayesian_ode_tpu/ops/fused_adaptive.py::make_fwd_rec_kernel (K2)
// as bayesian_ode_tpu/ops/fhn_dopri5.py registers the FHN field on the
// public engine (record = 1), and the same solve without records
// (record = 0).
//
// What bounds it on an H100: a field evaluation is about 8 FP32 operations
// per point, so a step's arithmetic is small beside its serial latency,
// and at full width the dense output and the record rows (bytes) are the
// least time the card could take.  One chain a thread left 316 warps at
// 10,112 chains (2-3 an SM), each thread carrying 2N components through a
// step; one point a thread, N consecutive lanes a chain, gives 1,686 warps
// (422 blocks of 128 threads, all resident at once) with each thread's
// chain N times shorter.  The error norm is gathered by shuffles over the
// chain's lanes and summed in the per-chain order, so the solves are the
// per-chain design's bit for bit.  theta sits in registers.
#include "dopri5_kernels.cuh"
#include "fhn_field.cuh"

extern "C" {

// Dimensions this library was built for.
int fhn_dopri5_dims(int* n_points) {
  *n_points = bode::kFN;
  return 0;
}

// a, b, c (C,); the rest as gp_dopri5_fwd.  Returns cudaGetLastError().
int fhn_dopri5_fwd(int record, int tableau, const float* a, const float* b,
                   const float* c, const float* x0, const float* f0,
                   const float* dt0, const float* ts, int C, int T,
                   float rtol, float atol, float safety, float ifactor,
                   float dfactor, int max_steps, int pi, int store_steps,
                   float* ys, int* nfe, int* nacc, int* nrej, float* t1,
                   float* rec, cudaStream_t stream) {
  const bode::FHNFwd::Args w{a, b, c};
  const bode::SolveArgs s{rtol, atol, safety, ifactor, dfactor, max_steps,
                          pi, record ? store_steps : 0};
  const bode::FwdOut o{ys, nfe, nacc, nrej, t1, record ? rec : nullptr};
  return bode::launch_fwd<bode::FHNFwd>(record, tableau, w, x0, f0, dt0, ts,
                                        C, T, s, o, stream);
}

// The shared memory of a block of each forward (DOPRI5 and TSIT5, each
// without and with records), static and dynamic: the shape check's
// arithmetic (ops/_build.py) against the build.
int fhn_dopri5_fwd_smem(int* bytes) {
  return bode::fwd_smem<bode::FHNFwd>(bytes);
}

}  // extern "C"
