// Whole adaptive dopri5 solve of the GP field, one chain per thread.
//
// Replaces two TPU kernels with one template:
//   RECORD = false: bayesian_ode_tpu/ops/gp_dopri5.py::_make_whole_kernel
//                   (K1, the non-recording whole solve);
//   RECORD = true:  bayesian_ode_tpu/ops/fused_adaptive.py::make_fwd_rec_kernel
//                   (K2, the forward that records the step mesh for the
//                   discrete adjoint).
// Being one template is what keeps K1 and K2 trajectories bit-equal.
//
// What bounds it on an H100: arithmetic and latency, not bytes.  Per
// attempted step a chain evaluates 6 x N x M = 1,080 expf at N=5, M=36,
// and reads only its own state; the chain's A row (M x 2) and the grid Z
// sit in shared memory, so the only device-memory traffic is the dense
// output (T x 2N floats per chain) and, for K2, one record row per
// accepted step.  Chains are independent with data-dependent step counts,
// so a thread runs its own while loop (no lockstep across the block: a
// warp only waits for its slowest lane).  Blocks of 64 threads give 158
// blocks at 10,112 chains, so all 132 SMs get work.
//
// Records: the TPU recorded every lockstep iteration of a 128-lane tile
// because a per-lane scatter is not a TPU vector op.  Here each chain
// records only its own accepted steps: y0 (2N floats), t0 and dt, laid out
// (store_steps, 2N + 2, C) so a warp's stores are coalesced.  Rejected
// steps pass the adjoint through unchanged, so this is the same
// frozen-mesh adjoint.  A chain that accepts more than store_steps steps
// stops recording; the wrapper sees n_accepted > store_steps and raises.
#include "dopri5_common.cuh"

namespace bode {

template <bool RECORD>
__global__ void __launch_bounds__(kBlock)
gp_dopri5_fwd_kernel(const float* __restrict__ A,
                     const float* __restrict__ x0,
                     const float* __restrict__ f0,
                     const float* __restrict__ dt0,
                     const float* __restrict__ Z,
                     const float* __restrict__ ts,
                     int C, int T, float sf2, float inv2ell2, float rtol,
                     float atol, float safety, float ifactor, float dfactor,
                     int max_steps, int pi, int store_steps,
                     float* __restrict__ ys, int* __restrict__ nfe_out,
                     int* __restrict__ nacc_out, int* __restrict__ nrej_out,
                     float* __restrict__ t1_out, float* __restrict__ rec) {
  __shared__ float sA[2 * kM * kBlock];
  __shared__ float sZ[2 * kM];
  stage_weights(A, Z, C, sA, sZ);
  __syncthreads();

  const int c = blockIdx.x * kBlock + threadIdx.x;
  if (c >= C) return;
  const GPField fld{sA, sZ, static_cast<int>(threadIdx.x), sf2, inv2ell2,
                    0.f};

  float y[kNS], k[7][kNS], y1[kNS], ym[kNS];
#pragma unroll
  for (int i = 0; i < kNS; ++i) {
    y[i] = x0[i];
    k[0][i] = f0[static_cast<size_t>(c) * kNS + i];
    ys[static_cast<size_t>(c) * kNS + i] = y[i];   // output row 0 is x0
  }
  const float tf = ts[T - 1];
  float t1 = ts[0];
  float dt = dt0[c];
  float ep = 1.0f;
  int nfe = 2, nacc = 0, nrej = 0, idx = 1;

  while (t1 < tf && nacc + nrej < max_steps) {
    rk_stages(fld, y, k, dt, y1);
    const Decision d = step_decision(k, y, y1, dt, rtol, atol, safety,
                                     ifactor, dfactor, pi != 0, ep);
    nfe += 6;
    if (d.accept) {
      if (RECORD && nacc < store_steps) {
        float* row = rec + static_cast<size_t>(nacc) * kRec * C + c;
#pragma unroll
        for (int i = 0; i < kNS; ++i) row[static_cast<size_t>(i) * C] = y[i];
        row[static_cast<size_t>(kNS) * C] = t1;
        row[static_cast<size_t>(kNS + 1) * C] = dt;
      }
      // in-loop dense output: every output time this step crossed
      const float tn = t1 + dt;
      if (idx < T && ts[idx] <= tn) {
        midpoint(y, k, dt, ym);
        for (; idx < T && ts[idx] <= tn; ++idx) {
          float* out = ys + (static_cast<size_t>(idx) * C + c) * kNS;
          if (!(ts[idx] > t1)) {
            // a repeated output time is never emitted; it reads 0, as the
            // zero-initialised output of the TPU kernel
#pragma unroll
            for (int i = 0; i < kNS; ++i) out[i] = 0.f;
            continue;
          }
          const float X = (ts[idx] - t1) / dt;
#pragma unroll
          for (int i = 0; i < kNS; ++i)
            out[i] = quartic_eval(y[i], y1[i], ym[i], k[0][i], k[6][i], dt, X);
        }
      }
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        y[i] = y1[i];
        k[0][i] = k[6][i];
      }
      t1 = tn;
      ++nacc;
    } else {
      ++nrej;
    }
    dt = d.dt_next;
    if (pi) ep = d.err_next;
  }
  // output times never crossed (only on budget exhaustion) hold the
  // chain's final state
  for (; idx < T; ++idx) {
    float* out = ys + (static_cast<size_t>(idx) * C + c) * kNS;
#pragma unroll
    for (int i = 0; i < kNS; ++i) out[i] = y[i];
  }
  nfe_out[c] = nfe;
  nacc_out[c] = nacc;
  nrej_out[c] = nrej;
  t1_out[c] = t1;
}

}  // namespace bode

extern "C" {

// Dimensions this library was built for.
int gp_dopri5_dims(int* n_points, int* n_inducing) {
  *n_points = bode::kN;
  *n_inducing = bode::kM;
  return 0;
}

// ys (T, C, N, 2); nfe/nacc/nrej (C,) int32; t1 (C,); rec
// (store_steps, 2N + 2, C) when record != 0.  Returns cudaGetLastError().
int gp_dopri5_fwd(int record, const float* A, const float* x0,
                  const float* f0, const float* dt0, const float* Z,
                  const float* ts, int C, int T, float sf2, float inv2ell2,
                  float rtol, float atol, float safety, float ifactor,
                  float dfactor, int max_steps, int pi, int store_steps,
                  float* ys, int* nfe, int* nacc, int* nrej, float* t1,
                  float* rec, cudaStream_t stream) {
  const dim3 grid((C + bode::kBlock - 1) / bode::kBlock);
  if (record) {
    bode::gp_dopri5_fwd_kernel<true><<<grid, bode::kBlock, 0, stream>>>(
        A, x0, f0, dt0, Z, ts, C, T, sf2, inv2ell2, rtol, atol, safety,
        ifactor, dfactor, max_steps, pi, store_steps, ys, nfe, nacc, nrej,
        t1, rec);
  } else {
    bode::gp_dopri5_fwd_kernel<false><<<grid, bode::kBlock, 0, stream>>>(
        A, x0, f0, dt0, Z, ts, C, T, sf2, inv2ell2, rtol, atol, safety,
        ifactor, dfactor, max_steps, pi, store_steps, ys, nfe, nacc, nrej,
        t1, rec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
