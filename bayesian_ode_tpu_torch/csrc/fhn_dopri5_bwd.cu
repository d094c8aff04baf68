// Frozen-step-mesh discrete adjoint of the whole adaptive solve of the
// FitzHugh-Nagumo theta-field, one trajectory point a thread: the backward
// kernel of dopri5_kernels.cuh over FHNBwd (fhn_field.cuh: FHNPoint, or
// FHNDopri5, one chain a thread, past 32 points a chain).
//
// Replaces bayesian_ode_tpu/ops/fused_adaptive.py::make_bwd_kernel (K3) as
// bayesian_ode_tpu/ops/fhn_dopri5.py registers the FHN field, with its
// hand-written VJP (_fhn_factory).
//
// What bounds it on an H100: the serial FMAs of a step (7 evaluations and
// 7 VJPs of a few operations per point) and the bytes of the records and
// the trajectory cotangent it reads.  One chain a thread kept the 2N
// components of every stage array in registers, in 158 blocks of 64
// threads at 10,112 chains; one point a thread keeps 2 of each and a
// thread's serial chain is one point's, in 422 blocks of 128 threads.
// The mesh is frozen, so the points' sweeps are independent: each thread
// adds its point's share of theta's cotangent in registers, and the
// chain's shares are summed by shuffles at the end (acc_store, ascending
// n), with no atomics.
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
  const bode::FHNBwd::Args w{a, b, c};
  const bode::FHNBwd::Grads gw{ga, gb, gc};
  return bode::launch_bwd<bode::FHNBwd>(tableau, w, gw, ts, rec, nrec, g, C,
                                        T, lbar, stream);
}

// The shared memory of a block of the backward at DOPRI5 and at TSIT5,
// static and dynamic: the shape check's arithmetic (ops/_build.py) against
// the build.
int fhn_dopri5_bwd_smem(int* bytes) {
  return bode::bwd_smem<bode::FHNBwd>(bytes);
}

}  // extern "C"
