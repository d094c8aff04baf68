// Frozen-step-mesh discrete adjoint of the whole adaptive solve of the MLP
// field, one warp per chain: the backward kernel of dopri5_kernels.cuh over
// MLPDopri5 (mlp_field.cuh).
//
// Replaces bayesian_ode_tpu/ops/fused_adaptive.py::make_bwd_kernel (K3) as
// bayesian_ode_tpu/ops/mlp_dopri5.py registers the MLP field, with the
// layer VJPs of ops/mlp_rk4.py::_mlp_factory.
//
// What bounds it on an H100: FP32 FMAs, shuffles and registers.  A step is
// 7 field evaluations and 7 VJPs at N points; a VJP adds the transposed
// H x H product through the per-warp shared scratch.  A lane holds 40
// weights and 40 weight cotangents in registers at H=32, so the step's 13
// stage vectors and their cotangents (the 2N-float arrays of StageBuf)
// live once per warp in shared memory instead, the same bits on every
// lane.  Weight cotangents are written once per chain, with no atomics.
#include "dopri5_kernels.cuh"
#include "mlp_field.cuh"

extern "C" {

// The six weight cotangents in the layout of the weights and lbar (C, N, 2)
// from the records of mlp_dopri5_fwd(record=1).  Returns
// cudaGetLastError().
int mlp_dopri5_bwd(int tableau, const float* w1, const float* b1,
                   const float* w2, const float* b2, const float* w3,
                   const float* b3, float* gw1, float* gb1, float* gw2,
                   float* gb2, float* gw3, float* gb3, const float* ts,
                   const float* rec, const int* nrec, const float* g, int C,
                   int T, float* lbar, cudaStream_t stream) {
  const bode::MLPDopri5::Args w{w1, b1, w2, b2, w3, b3};
  const bode::MLPDopri5::Grads gw{gw1, gb1, gw2, gb2, gw3, gb3};
  return bode::launch_bwd<bode::MLPDopri5>(tableau, w, gw, ts, rec, nrec, g,
                                           C, T, lbar, stream);
}

}  // extern "C"
