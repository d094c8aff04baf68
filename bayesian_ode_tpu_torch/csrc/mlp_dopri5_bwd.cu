// Frozen-step-mesh discrete adjoint of the whole adaptive solve of the MLP
// field, one warp per chain: the backward kernel of dopri5_kernels.cuh over
// MLPDopri5 (mlp_field.cuh).
//
// Replaces bayesian_ode_tpu/ops/fused_adaptive.py::make_bwd_kernel (K3) as
// bayesian_ode_tpu/ops/mlp_dopri5.py registers the MLP field, with the
// layer VJPs of ops/mlp_rk4.py::_mlp_factory.
//
// What bounds it on an H100: the MIO pipe (shuffles and shared-memory
// instructions), then the FP32 FMAs of the H x H products, over each
// chain's serial replay.  An accepted step evaluates the field at its 7
// stage points once, keeping each point's activations in a stage slot of
// the warp's shared buffer (field_stages.cuh), and takes the 7 VJPs from
// them with no second hidden layer (7 hidden passes a step, not 14).  The
// step's stage arrays are distributed over the warp, component i on lane
// i, in registers (StageBuf of 1 float a lane); W2 sits in shared memory,
// so a lane's 8 weights and 40 weight cotangents and its stage arrays fit
// 128 registers.  The warp's buffer is 13,952 B at N=5, H=32; two chains a
// block, 8 blocks (16 warps) an SM.  Weight cotangents
// are written once per chain, with no atomics.
// Past H = 32 or N = 16 the same templates run over mlp_wide_field.cuh's
// MLPDopri5Fwd and MLPDopri5 (one warp and block a chain, W2 in the
// warp's buffer in dynamic shared memory).
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

// The shared memory of a block of the backward at DOPRI5 and at TSIT5,
// static and dynamic: the shape check's arithmetic (ops/_build.py) against
// the build.
int mlp_dopri5_bwd_smem(int* bytes) {
  return bode::bwd_smem<bode::MLPDopri5>(bytes);
}

}  // extern "C"
