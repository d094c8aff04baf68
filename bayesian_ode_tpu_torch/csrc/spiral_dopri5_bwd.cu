// Frozen-step-mesh discrete adjoint of the whole adaptive solve of the
// spiral y^3-net field, one warp per chain: the backward kernel of
// dopri5_kernels.cuh over SpiralDopri5 (spiral_field.cuh).
//
// Replaces bayesian_ode_tpu/ops/fused_adaptive.py::make_bwd_kernel (K3) as
// bayesian_ode_tpu/ops/spiral_dopri5.py registers the spiral field, with
// its hand-written VJP (_spiral_factory).
//
// What bounds it on an H100: the MIO pipe (shuffles and shared memory
// instructions) beside tanhf.  A step is 7 field evaluations and 7 VJPs
// at N points, each H tanhf over the warp at the evaluations alone (the
// stage slots keep the tanh values for the VJPs).  Each lane carries one
// state component of the step's stage vectors and cotangents in
// registers; the N points reach the warp through its shared copy of them,
// and the 2N sums of an evaluation or a VJP are one 16-wide
// reduce-scatter (spiral_field.cuh).  The weights and their cotangents
// (12 + 12 floats a lane at H=50) stay in registers; weight cotangents are
// written once per chain, with no atomics.
#include "dopri5_kernels.cuh"
#include "spiral_field.cuh"

extern "C" {

// The four weight cotangents in the layout of the weights and lbar
// (C, N, 2) from the records of spiral_dopri5_fwd(record=1).  Returns
// cudaGetLastError().
int spiral_dopri5_bwd(int tableau, const float* w1, const float* b1,
                      const float* w2, const float* b2, float* gw1,
                      float* gb1, float* gw2, float* gb2, const float* ts,
                      const float* rec, const int* nrec, const float* g,
                      int C, int T, float* lbar, cudaStream_t stream) {
  const bode::SpiralDopri5::Args w{w1, b1, w2, b2};
  const bode::SpiralDopri5::Grads gw{gw1, gb1, gw2, gb2};
  return bode::launch_bwd<bode::SpiralDopri5>(tableau, w, gw, ts, rec, nrec,
                                              g, C, T, lbar, stream);
}

// The shared memory of a block of the backward at DOPRI5 and at TSIT5,
// static and dynamic: the shape check's arithmetic (ops/_build.py) against
// the build.
int spiral_dopri5_bwd_smem(int* bytes) {
  return bode::bwd_smem<bode::SpiralDopri5>(bytes);
}

}  // extern "C"
