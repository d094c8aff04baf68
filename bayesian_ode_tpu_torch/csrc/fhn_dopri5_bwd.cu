// Frozen-step-mesh discrete adjoint of the whole adaptive solve of the
// FitzHugh-Nagumo theta-field, one chain per thread: the backward kernel
// of dopri5_kernels.cuh over FHNDopri5 (fhn_field.cuh).
//
// Replaces bayesian_ode_tpu/ops/fused_adaptive.py::make_bwd_kernel (K3) as
// bayesian_ode_tpu/ops/fhn_dopri5.py registers the FHN field, with its
// hand-written VJP (_fhn_factory).
//
// What bounds it on an H100: the serial FMAs of a step (7 evaluations and
// 7 VJPs of a few operations per point) and the bytes of the records and
// the trajectory cotangent it reads.  The stage arrays and theta's
// cotangent stay in registers; each chain writes its three cotangents
// once, with no atomics.
#include "dopri5_kernels.cuh"
#include "fhn_field.cuh"

extern "C" {

// The cotangents of a, b, c (C,) and lbar (C, N, 2) from the records of
// fhn_dopri5_fwd(record=1).  Returns cudaGetLastError().
int fhn_dopri5_bwd(int tableau, const float* a, const float* b,
                   const float* c, float* ga, float* gb, float* gc,
                   const float* ts, const float* rec, const int* nrec,
                   const float* g, int C, int T, float* lbar,
                   cudaStream_t stream) {
  const bode::FHNDopri5::Args w{a, b, c};
  const bode::FHNDopri5::Grads gw{ga, gb, gc};
  return bode::launch_bwd<bode::FHNDopri5>(tableau, w, gw, ts, rec, nrec, g,
                                           C, T, lbar, stream);
}

// The shared memory of a block of the backward at DOPRI5 and at TSIT5,
// static and dynamic: the shape check's arithmetic (ops/_build.py) against
// the build.
int fhn_dopri5_bwd_smem(int* bytes) {
  return bode::bwd_smem<bode::FHNDopri5>(bytes);
}

}  // extern "C"
