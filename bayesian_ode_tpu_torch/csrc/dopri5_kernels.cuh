// The fused adaptive kernels, as templates over a field and a tableau.
//
// Replaces the two kernel bodies of bayesian_ode_tpu/ops/fused_adaptive.py
// that the public engine ops/fused_field.py instantiates over every field:
//   dopri5_fwd_kernel<F, TB, true>:  make_fwd_rec_kernel (K2), the whole
//       adaptive solve, recording each chain's accepted steps for the
//       adjoint;
//   dopri5_fwd_kernel<F, TB, false>: the same solve with no records, which
//       for the GP field replaces ops/gp_dopri5.py::_make_whole_kernel (K1).
//       One template is what keeps K1 and K2 trajectories bit-equal
//       (dopri5_fwd_kernel_bounded for a field that names its blocks an
//       SM);
//   dopri5_bwd_kernel<F, TB>:        make_bwd_kernel (K3), the frozen-mesh
//       discrete adjoint over the records (dopri5_bwd_kernel_bounded for a
//       field that names its blocks an SM);
//   dopri5_step_kernel<F, TB>:       for the GP field, ops/gp_dopri5.py::
//       _make_kernel (K9) and the while loop around it: one output
//       interval of the per-step solver, its dense output included.
// TB is Dopri5 or Tsit5 (dopri5_common.cuh).
//
// A field F (gp_field.cuh, mlp_field.cuh, spiral_field.cuh, fhn_field.cuh)
// provides
//   kNS, kThreads, kChains        state floats per chain, threads and
//                                 chains per block;
//   Args, Grads                   weights (and scalars) by value, and the
//                                 weight-cotangent outputs;
//   Smem, AccSmem, Acc            the block's shared memory for the
//                                 weights and for the cotangents (static,
//                                 or dynamic where the field declares
//                                 kDynamicSmem: field_stages.cuh), and a
//                                 thread's cotangent accumulator;
//   chain(), leader()             this thread's chain, and whether it
//                                 writes the chain's outputs (once per
//                                 chain; where the forward spreads the
//                                 state, its t0, dt and counters);
//   load(args, smem, C, c)        called by every thread of the block
//                                 (it may __syncthreads);
//   acc_init(accsmem), acc_store(acc, grads, c)   likewise for acc_init;
//   rhs(y, f), rhs_vjp(y, cot, ybar, acc);
// and the kernels take the optional stage slots and state spreading of
// field_stages.cuh (slot 0 is a step's start y0, slot r + 1 its stage
// point u[r]; the forwards spread the state where the field provides
// norm_sums), and two optional members:
//   kMinBlocks                    blocks an SM must hold (the second
//                                 argument of __launch_bounds__ of the
//                                 forwards and the backward; absent,
//                                 ptxas picks the registers);
//   kWarpStore                    acc_store is a collective (it sums the
//                                 lanes' cotangents by shuffles, or reads
//                                 a chain's columns after a barrier): every
//                                 lane of the warp reaches it, a lane with
//                                 no chain (c >= C) with c = -1, after a
//                                 sweep of no records.  Without it such a
//                                 thread leaves at once.
// A field whose chain spans several warps (GPWidePoint past N = 32,
// gp_wide_field.cuh) is one chain a block: its norm_sums and acc_store
// take block barriers, which every thread of the block reaches, since all
// take the chain's steps.
//
// What bounds the kernels on an H100: the serial per-chain chain of field
// evaluations, not bytes.  Chains are independent with data-dependent step
// counts, so a chain runs its own while loop (a warp only waits for its
// slowest chain; the threads of a chain take every decision together,
// since warp sums and norm_sums leave the same bits on each of them).  Device
// memory sees only the dense output (T x 2N floats per chain), one record
// row per accepted step, and the weights, read once per chain.
//
// Records: the TPU recorded every lockstep iteration of a 128-lane tile,
// because a per-lane scatter is not a TPU vector op.  Here each chain
// records only its own accepted steps: y0 (2N floats), t0 and dt, laid out
// (store_steps, 2N + 2, C) so that neighbouring chains' stores coalesce.
// Rejected steps pass the adjoint through unchanged, so this is the same
// frozen-mesh adjoint.  A chain that accepts more than store_steps steps
// stops recording; the wrapper sees n_accepted > store_steps and raises.
#pragma once

#include "dopri5_common.cuh"
#include "field_stages.cuh"
#include "warp.cuh"

namespace bode {

// Step controller and record budget of one launch.
struct SolveArgs {
  float rtol, atol, safety, ifactor, dfactor;
  int max_steps, pi, store_steps;
};

struct FwdOut {
  float* ys;       // (T, C, 2N)
  int* nfe;        // (C,)
  int* nacc;
  int* nrej;
  float* t1;
  float* rec;      // (store_steps, 2N + 2, C), or null
};

// One block of the whole solve (K1, K2).  A thread carries its
// fwd_components of the chain's state (field_stages.cuh) and writes them
// to the dense output and the records where it owns them; the chain's
// leader writes t0, dt and the counters.
template <class F, class TB, bool RECORD>
__device__ __forceinline__ void fwd_block(
    const typename F::Args& w, const float* __restrict__ x0,
    const float* __restrict__ f0, const float* __restrict__ dt0,
    const float* __restrict__ ts, int C, int T, const SolveArgs& s,
    const FwdOut& o) {
  constexpr int NS = fwd_components<F>();   // components carried here
  constexpr int kNS = F::kNS;
  constexpr int kRec = kNS + 2;     // record row: y0[kNS], t0, dt
  const int c = F::chain();
  const F fld = F::load(w, block_smem<F>(), C, c);
  if (c >= C) return;    // a chain's threads leave together
  const bool lead = F::leader();
  const bool own = fwd_owner<F>();

  float y[NS], k[7][NS], y1[NS], ym[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int j = fwd_component<F>(i);
    y[i] = x0[j];
    k[0][i] = f0[static_cast<size_t>(c) * kNS + j];
    if (own && owns<F>(i))
      o.ys[static_cast<size_t>(c) * kNS + j] = y[i];          // row 0 is x0
  }
  const float tf = ts[T - 1];
  float t1 = ts[0];
  float dt = dt0[c];
  float ep = 1.0f;
  int nfe = 2, nacc = 0, nrej = 0, idx = 1;

  while (t1 < tf && nacc + nrej < s.max_steps) {
    rk_stages<NS, TB>(fld, y, k, dt, y1);
    const Decision d = step_decision<NS, TB>(
        fld, k, y, y1, dt, s.rtol, s.atol, s.safety, s.ifactor, s.dfactor,
        s.pi != 0, ep);
    nfe += 6;
    if (d.accept) {
      if (RECORD && nacc < s.store_steps) {
        float* row = o.rec + static_cast<size_t>(nacc) * kRec * C + c;
        if (own) {
#pragma unroll
          for (int i = 0; i < NS; ++i)
            if (owns<F>(i))
              row[static_cast<size_t>(fwd_component<F>(i)) * C] = y[i];
        }
        if (lead) {
          row[static_cast<size_t>(kNS) * C] = t1;
          row[static_cast<size_t>(kNS + 1) * C] = dt;
        }
      }
      // in-loop dense output: every output time this step crossed
      const float tn = t1 + dt;
      if (idx < T && ts[idx] <= tn) {
        midpoint<NS, TB>(y, k, dt, ym);
        for (; idx < T && ts[idx] <= tn; ++idx) {
          if (!own) continue;
          float* out = o.ys + (static_cast<size_t>(idx) * C + c) * kNS;
          if (!(ts[idx] > t1)) {
            // a repeated output time is never emitted; it reads 0, as the
            // zero-initialised output of the TPU kernel
#pragma unroll
            for (int i = 0; i < NS; ++i)
              if (owns<F>(i)) out[fwd_component<F>(i)] = 0.f;
            continue;
          }
          const float X = (ts[idx] - t1) / dt;
#pragma unroll
          for (int i = 0; i < NS; ++i)
            if (owns<F>(i))
              out[fwd_component<F>(i)] =
                  quartic_eval(y[i], y1[i], ym[i], k[0][i], k[6][i], dt, X);
        }
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        y[i] = y1[i];
        k[0][i] = k[6][i];
      }
      t1 = tn;
      ++nacc;
    } else {
      ++nrej;
    }
    dt = d.dt_next;
    if (s.pi) ep = d.err_next;
  }
  // output times never crossed (only on budget exhaustion) hold the
  // chain's final state
  if (own) {
    for (; idx < T; ++idx) {
      float* out = o.ys + (static_cast<size_t>(idx) * C + c) * kNS;
#pragma unroll
      for (int i = 0; i < NS; ++i)
        if (owns<F>(i)) out[fwd_component<F>(i)] = y[i];
    }
  }
  if (!lead) return;
  o.nfe[c] = nfe;
  o.nacc[c] = nacc;
  o.nrej[c] = nrej;
  o.t1[c] = t1;
}

template <class F, class TB, bool RECORD>
__global__ void __launch_bounds__(F::kThreads)
dopri5_fwd_kernel(typename F::Args w, const float* __restrict__ x0,
                  const float* __restrict__ f0, const float* __restrict__ dt0,
                  const float* __restrict__ ts, int C, int T, SolveArgs s,
                  FwdOut o) {
  fwd_block<F, TB, RECORD>(w, x0, f0, dt0, ts, C, T, s, o);
}

template <class F, class TB, bool RECORD>
__global__ void __launch_bounds__(F::kThreads, F::kMinBlocks)
dopri5_fwd_kernel_bounded(typename F::Args w, const float* __restrict__ x0,
                          const float* __restrict__ f0,
                          const float* __restrict__ dt0,
                          const float* __restrict__ ts, int C, int T,
                          SolveArgs s, FwdOut o) {
  fwd_block<F, TB, RECORD>(w, x0, f0, dt0, ts, C, T, s, o);
}

// The per-step solver's state (K9), kept in device memory between
// launches: each launch reads a chain's row, takes its steps, writes its
// dense output at the launch's output time and the row back.
struct StepState {
  float* y;        // (C, NS) state at t1
  float* f;        // (C, NS) FSAL slope at t1
  float* t0;       // (C,) start of the last accepted step
  float* t1;       // (C,) its end
  float* dt;       // (C,) proposed next step
  float* coef;     // (5, C, NS) quartic of the last accepted step, a..e
  int* nfe;        // (C,)
  int* nacc;
  int* nrej;
  // this launch's flags, zeroed before it: [0] is 1 if a chain is still
  // short of ts[k] after it (the interval needs another launch, budget
  // allowing), [1] the most steps (accepted + rejected) any chain has
  // taken.  Where the launches of all intervals are issued at once, each
  // interval k has its pair at flags + 2k, and the pair before it holds
  // the previous launch's.
  int* flags;
};

// A launch's cap of iterations: the budget left, rounded up to a multiple
// of steps_per_call (the JAX loop checks its budget once every
// steps_per_call steps), 0 once it is spent, at most the largest such
// multiple an int holds; ops/gp_dopri5.py::_cap is the same arithmetic.
__device__ __forceinline__ int interval_cap(int left, int steps_per_call) {
  if (left <= 0) return 0;
  const long long spc = steps_per_call;
  const long long cap = (left + spc - 1) / spc * spc;
  const long long most = 2147483647LL / spc * spc;
  return static_cast<int>(cap < most ? cap : most);
}

// The dense output of one component at t in the order of the port's
// ode/interp.py interp_evaluate: X = (t - t0) / (t1 - t0), 0 for a step of
// zero length, then Horner, each operation rounded on its own (the _rn
// intrinsics are never contracted), so that it is the plain version's
// evaluation bit for bit.
__device__ __forceinline__ float dense_output(const float (&cf)[5], float X) {
  float v = __fadd_rn(__fmul_rn(cf[0], X), cf[1]);
  v = __fadd_rn(__fmul_rn(v, X), cf[2]);
  v = __fadd_rn(__fmul_rn(v, X), cf[3]);
  return __fadd_rn(__fmul_rn(v, X), cf[4]);
}

// One output interval of the per-step solver: replaces ops/gp_dopri5.py::
// _make_kernel (K9) with the device-side loop of its lax.while_loop.
// Every chain still short of ts[k] steps while t1 < ts[k], for at most
// `cap` iterations; a negative cap is read from the previous launch's
// flags (interval_cap of the budget left after it), so that the launches
// of all intervals can be issued at once.  An active chain takes the step
// of the whole solve (the same rk_stages, step_decision with the "i"
// controller and midpoint as K1), so the two take the same steps.  On
// acceptance the step's quartic is kept, and at the end every chain
// writes its dense output at ts[k] (extrapolated where a spent budget
// left it short, as in JAX) and its state.  The chain's threads spread its
// state as K1's do (field_stages.cuh) and leave the loop together.  Every
// lane of the warp reaches the flags' warp reductions (a lane with no
// chain takes no step); the warp's lane 0 then updates them with one
// atomic each.
template <class F, class TB>
__global__ void __launch_bounds__(F::kThreads, F::kMinBlocks)
dopri5_step_kernel(typename F::Args w, const float* __restrict__ ts, int k,
                   int C, int cap, int max_steps, int steps_per_call,
                   SolveArgs s, StepState st, float* __restrict__ ys) {
  constexpr int NS = fwd_components<F>();   // components carried here
  constexpr int kNS = F::kNS;
  const int c = F::chain();
  const F fld = F::load(w, block_smem<F>(), C, c);
  const bool live = c < C;
  const float next_t = ts[k];
  if (cap < 0) cap = interval_cap(max_steps - st.flags[-1], steps_per_call);
  float t0 = 0.f, t1 = next_t, dt = 0.f;
  int nfe = 0, nacc = 0, nrej = 0;
  if (live) {
    float y[NS], kk[7][NS], y1[NS], ym[NS], cf[5][NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const size_t j = static_cast<size_t>(c) * kNS + fwd_component<F>(i);
      y[i] = st.y[j];
      kk[0][i] = st.f[j];
#pragma unroll
      for (int q = 0; q < 5; ++q)
        cf[q][i] = st.coef[static_cast<size_t>(q) * C * kNS + j];
    }
    t0 = st.t0[c];
    t1 = st.t1[c];
    dt = st.dt[c];
    nfe = st.nfe[c];
    nacc = st.nacc[c];
    nrej = st.nrej[c];
    int it = 0;
    for (; it < cap && t1 < next_t; ++it) {
      rk_stages<NS, TB>(fld, y, kk, dt, y1);
      const Decision d = step_decision<NS, TB>(
          fld, kk, y, y1, dt, s.rtol, s.atol, s.safety, s.ifactor,
          s.dfactor, false, 1.0f);
      nfe += 6;
      if (d.accept) {
        midpoint<NS, TB>(y, kk, dt, ym);
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          float q[5];
          quartic_coeffs(y[i], y1[i], ym[i], kk[0][i], kk[6][i], dt, q);
#pragma unroll
          for (int j = 0; j < 5; ++j) cf[j][i] = q[j];
          y[i] = y1[i];
          kk[0][i] = kk[6][i];
        }
        t0 = t1;
        t1 = t1 + dt;
        ++nacc;
      } else {
        ++nrej;
      }
      dt = d.dt_next;
    }
    // the dense output at ts[k], and the state where this launch moved it
    const bool same = t1 == t0;
    const float X =
        same ? 0.f : __fdiv_rn(__fsub_rn(next_t, t0), __fsub_rn(t1, t0));
    if (fwd_owner<F>()) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        if (!owns<F>(i)) continue;
        const size_t j = static_cast<size_t>(c) * kNS + fwd_component<F>(i);
        const float q[5] = {cf[0][i], cf[1][i], cf[2][i], cf[3][i],
                            cf[4][i]};
        ys[static_cast<size_t>(k) * C * kNS + j] = dense_output(q, X);
        if (it == 0) continue;
        st.y[j] = y[i];
        st.f[j] = kk[0][i];
#pragma unroll
        for (int r = 0; r < 5; ++r)
          st.coef[static_cast<size_t>(r) * C * kNS + j] = cf[r][i];
      }
    }
    if (it > 0 && F::leader()) {
      st.t0[c] = t0;
      st.t1[c] = t1;
      st.dt[c] = dt;
      st.nfe[c] = nfe;
      st.nacc[c] = nacc;
      st.nrej[c] = nrej;
    }
  }
  // the launch's flags, over the warp's chains first (every thread of a
  // chain holds the same t1 and counters; a lane with no chain adds 0)
  const int short_k = __reduce_max_sync(kFull, live && t1 < next_t ? 1 : 0);
  const int taken = __reduce_max_sync(kFull, live ? nacc + nrej : 0);
  if ((threadIdx.x & 31) == 0) {
    if (short_k) atomicMax(&st.flags[0], 1);
    if (taken) atomicMax(&st.flags[1], taken);
  }
}

// The backward's per-step arrays, in registers: NS of the chain's
// components, all of them on a chain-per-thread field, or the ones a
// thread carries where the field spreads the state (the warp-per-chain
// fields: one a lane).
template <int NS>
struct StageBuf {
  float y0[NS];
  float k[7][NS];        // stage derivatives
  float u[6][NS];        // stage points
  float kb[7][NS];       // their cotangents
  float y0b[NS], y1b[NS], f0b[NS], f1b[NS], cot[NS], ub[NS];
};

// Chain c's reverse sweep over its records: on return l is the x0
// cotangent of its trajectory rows 1..T-1; the weight cotangents are in acc.
template <class F, class TB>
__device__ __forceinline__ void bwd_sweep(
    const F& fld, typename F::Acc& acc, StageBuf<own_components<F>()>& b,
    const float* __restrict__ ts, const float* __restrict__ rec, int n,
    const float* __restrict__ g, int C, int T, int c, float* l) {
  constexpr int NS = own_components<F>();   // components carried here
  constexpr int kRec = F::kNS + 2;
#pragma unroll
  for (int i = 0; i < NS; ++i) l[i] = 0.f;
  int p = T - 1;

  for (int s = n - 1; s >= 0; --s) {
    const float* row = rec + static_cast<size_t>(s) * kRec * C + c;
#pragma unroll
    for (int i = 0; i < NS; ++i)
      b.y0[i] = row[static_cast<size_t>(own_component<F>(i)) * C];
    const float t0 = row[static_cast<size_t>(F::kNS) * C];
    const float dt = row[static_cast<size_t>(F::kNS + 1) * C];
    const float dts = dt > 0.f ? dt : 1.0f;

    // 1. recompute the stages, keeping the stage points u[0..5] (and, for
    //    a field with stage slots, their activations; k[6] = f(u[5]) is
    //    never needed)
    stage_rhs(fld, 0, b.y0, b.k[0]);
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      stage_point<NS, TB>(r, b.y0, b.k, dts, b.u[r]);
      if (r < 5)
        stage_rhs(fld, r + 1, b.u[r], b.k[r + 1]);
      else
        stage_hidden(fld, r + 1, b.u[r]);
    }

    // 2. cotangents of the emitted output times -> quartic coefficients
    float ca[NS], cb[NS], cc[NS], cd[NS], ce[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) ca[i] = cb[i] = cc[i] = cd[i] = ce[i] = 0.f;
    const float tn = t0 + dt;
    while (p >= 1 && ts[p] > tn) --p;      // never reached: no cotangent
    for (; p >= 1 && ts[p] > t0; --p) {
      const float X1 = (ts[p] - t0) / dts;
      const float X2 = X1 * X1;
      const float X3 = X2 * X1;
      const float X4 = X2 * X2;
      const float* gp = g + (static_cast<size_t>(p) * C + c) * F::kNS;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const float wg = gp[own_component<F>(i)];
        ca[i] += wg * X4;
        cb[i] += wg * X3;
        cc[i] += wg * X2;
        cd[i] += wg * X1;
        ce[i] += wg;
      }
    }

#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const float a = ca[i], bq = cb[i], cq = cc[i], d = cd[i], e = ce[i];
      b.y0b[i] = -8.0f * a + 18.0f * bq - 11.0f * cq + e;
      b.y1b[i] = -8.0f * a + 14.0f * bq - 5.0f * cq;
      const float ymb = 16.0f * a - 32.0f * bq + 16.0f * cq;
      b.f0b[i] = dts * (-2.0f * a + 5.0f * bq - 4.0f * cq + d);
      b.f1b[i] = dts * (2.0f * a - 3.0f * bq + cq);
      // 3. y_mid = y0 + dt * (c_mid . k)
#pragma unroll
      for (int j = 0; j < 7; ++j) {
        const float cm = static_cast<float>(TB::c_mid(j));
        b.kb[j][i] = cm != 0.f ? (dts * cm) * ymb : 0.f;
      }
      b.y0b[i] += ymb;
    }

    // 4. transposed stage recurrence
    // k7 = f(y1): its cotangent is the carried-in f1 share + the c_mid share
#pragma unroll
    for (int i = 0; i < NS; ++i) b.cot[i] = b.kb[6][i] + b.f1b[i];
    stage_vjp(fld, 6, b.u[5], b.cot, b.ub, acc);
    // y1 = y0 + dt * (beta[5] . k)
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const float y1t = l[i] + b.y1b[i] + b.ub[i];
      b.y0b[i] += y1t;
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const float bb = static_cast<float>(TB::beta(5, j));
        if (bb != 0.f) b.kb[j][i] += (dts * bb) * y1t;
      }
    }
    // stages 6..2: k[r + 1] = f(u[r]), u[r] = y0 + dt * (beta[r] . k)
#pragma unroll
    for (int r = 4; r >= 0; --r) {
      stage_vjp(fld, r + 1, b.u[r], b.kb[r + 1], b.ub, acc);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        b.y0b[i] += b.ub[i];
#pragma unroll
        for (int j = 0; j <= 4; ++j) {
          if (j > r) break;
          const float bb = static_cast<float>(TB::beta(r, j));
          if (bb != 0.f) b.kb[j][i] += (dts * bb) * b.ub[i];
        }
      }
    }
    // k1 = f(y0): the FSAL slope is recomputed, so f0's share lands here
#pragma unroll
    for (int i = 0; i < NS; ++i) b.cot[i] = b.kb[0][i] + b.f0b[i];
    stage_vjp(fld, 0, b.y0, b.cot, b.ub, acc);
#pragma unroll
    for (int i = 0; i < NS; ++i) l[i] = b.y0b[i] + b.ub[i];
  }
}

template <class F, class = void>
struct has_min_blocks : std::false_type {};
template <class F>
struct has_min_blocks<F, std::void_t<decltype(F::kMinBlocks)>>
    : std::true_type {};

template <class F, class = void>
struct warp_store : std::false_type {};
template <class F>
struct warp_store<F, std::void_t<decltype(F::kWarpStore)>>
    : std::true_type {};

// One block of the replay backward (K3).
template <class F, class TB>
__device__ __forceinline__ void bwd_block(
    const typename F::Args& w, const typename F::Grads& gw,
    const float* __restrict__ ts, const float* __restrict__ rec,
    const int* __restrict__ nrec, const float* __restrict__ g, int C, int T,
    float* __restrict__ lbar) {
  constexpr int NS = own_components<F>();
  const int c = F::chain();
  const F fld = F::load(w, block_smem<F>(), C, c);
  typename F::Acc acc = F::acc_init(block_acc_smem<F>());
  const bool live = c < C;
  if (!warp_store<F>::value && !live) return;
  const int n = live ? nrec[c] : 0;

  float l[NS];
  StageBuf<NS> buf;
  bwd_sweep<F, TB>(fld, acc, buf, ts, rec, n, g, C, T, c, l);
  if (live && owner<F>()) {
#pragma unroll
    for (int i = 0; i < NS; ++i)
      if (owns<F>(i))
        lbar[static_cast<size_t>(c) * F::kNS + own_component<F>(i)] = l[i];
  }
  F::acc_store(acc, gw, live ? c : -1);
}

// The replay backward kernel, and its instance for a field that declares
// kMinBlocks (so for the forwards).  Two kernels, because naming a minimum
// of 1 block an SM is not the same as naming none: ptxas then gives the
// MLP field's K3 146 registers where it picks 128 by itself, and 12% more
// time on an H100.
template <class F, class TB>
__global__ void __launch_bounds__(F::kThreads)
dopri5_bwd_kernel(typename F::Args w, typename F::Grads gw,
                  const float* __restrict__ ts, const float* __restrict__ rec,
                  const int* __restrict__ nrec, const float* __restrict__ g,
                  int C, int T, float* __restrict__ lbar) {
  bwd_block<F, TB>(w, gw, ts, rec, nrec, g, C, T, lbar);
}

template <class F, class TB>
__global__ void __launch_bounds__(F::kThreads, F::kMinBlocks)
dopri5_bwd_kernel_bounded(typename F::Args w, typename F::Grads gw,
                          const float* __restrict__ ts,
                          const float* __restrict__ rec,
                          const int* __restrict__ nrec,
                          const float* __restrict__ g, int C, int T,
                          float* __restrict__ lbar) {
  bwd_block<F, TB>(w, gw, ts, rec, nrec, g, C, T, lbar);
}

// The kernels a field's launches take: the bounded instances where it
// names its blocks an SM.
template <class F, class TB, bool RECORD>
auto fwd_kernel() {
  if constexpr (has_min_blocks<F>::value)
    return &dopri5_fwd_kernel_bounded<F, TB, RECORD>;
  else
    return &dopri5_fwd_kernel<F, TB, RECORD>;
}

template <class F, class TB>
auto bwd_kernel() {
  if constexpr (has_min_blocks<F>::value)
    return &dopri5_bwd_kernel_bounded<F, TB>;
  else
    return &dopri5_bwd_kernel<F, TB>;
}

// Host launchers: tableau 0 is DOPRI5, 1 is TSIT5.  Return
// cudaGetLastError() (or the error of raising the block's shared-memory
// limit).  The launchers that keep that limit's result in a local static
// have internal linkage (`static`): a static local of a function template
// with external linkage is one object in the whole process (a GNU unique
// symbol), shared by every library of the family loaded beside this one,
// so a library built for another inducing grid would skip raising its own
// kernel's limit.
template <class F, class TB, bool RECORD>
static int launch_fwd_as(const typename F::Args& w, const float* x0,
                  const float* f0, const float* dt0, const float* ts, int C,
                  int T, const SolveArgs& s, const FwdOut& o,
                  cudaStream_t stream) {
  const auto kernel = fwd_kernel<F, TB, RECORD>();
  constexpr size_t bytes = smem_bytes<F, false>();
  static const cudaError_t allowed = allow_smem(kernel, bytes);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  const dim3 grid((C + F::kChains - 1) / F::kChains);
  kernel<<<grid, F::kThreads, bytes, stream>>>(w, x0, f0, dt0, ts, C, T, s,
                                                o);
  return static_cast<int>(cudaGetLastError());
}

template <class F>
int launch_fwd(int record, int tableau, const typename F::Args& w,
               const float* x0, const float* f0, const float* dt0,
               const float* ts, int C, int T, const SolveArgs& s,
               const FwdOut& o, cudaStream_t stream) {
  if (tableau == 0 && record)
    return launch_fwd_as<F, Dopri5, true>(w, x0, f0, dt0, ts, C, T, s, o,
                                          stream);
  if (tableau == 0)
    return launch_fwd_as<F, Dopri5, false>(w, x0, f0, dt0, ts, C, T, s, o,
                                           stream);
  if (record)
    return launch_fwd_as<F, Tsit5, true>(w, x0, f0, dt0, ts, C, T, s, o,
                                         stream);
  return launch_fwd_as<F, Tsit5, false>(w, x0, f0, dt0, ts, C, T, s, o,
                                        stream);
}

template <class F, class TB>
static int launch_bwd_as(const typename F::Args& w, const typename F::Grads& gw,
                  const float* ts, const float* rec, const int* nrec,
                  const float* g, int C, int T, float* lbar,
                  cudaStream_t stream) {
  const auto kernel = bwd_kernel<F, TB>();
  constexpr size_t bytes = smem_bytes<F, true>();
  static const cudaError_t allowed = allow_smem(kernel, bytes);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  const dim3 grid((C + F::kChains - 1) / F::kChains);
  kernel<<<grid, F::kThreads, bytes, stream>>>(w, gw, ts, rec, nrec, g, C,
                                                T, lbar);
  return static_cast<int>(cudaGetLastError());
}

template <class F>
int launch_bwd(int tableau, const typename F::Args& w,
               const typename F::Grads& gw, const float* ts,
               const float* rec, const int* nrec, const float* g, int C,
               int T, float* lbar, cudaStream_t stream) {
  if (tableau == 0)
    return launch_bwd_as<F, Dopri5>(w, gw, ts, rec, nrec, g, C, T, lbar,
                                    stream);
  return launch_bwd_as<F, Tsit5>(w, gw, ts, rec, nrec, g, C, T, lbar,
                                 stream);
}

// The per-step solver at DOPRI5 (the JAX per-step kernel's only tableau):
// one launch for output interval k with a cap of iterations from the host,
// after zeroing its flags (launch_step), or the launches of all output
// intervals 1..T-1 at once, each with its cap from the flags of the one
// before it, after zeroing all T pairs of flags (launch_steps).
template <class F>
static int launch_step_as(const typename F::Args& w, const float* ts, int k,
                          int C, int cap, int max_steps, int steps_per_call,
                          const SolveArgs& s, const StepState& st, float* ys,
                          cudaStream_t stream) {
  const auto kernel = &dopri5_step_kernel<F, Dopri5>;
  constexpr size_t bytes = smem_bytes<F, false>();
  static const cudaError_t allowed = allow_smem(kernel, bytes);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  const dim3 grid((C + F::kChains - 1) / F::kChains);
  kernel<<<grid, F::kThreads, bytes, stream>>>(w, ts, k, C, cap, max_steps,
                                                steps_per_call, s, st, ys);
  return static_cast<int>(cudaGetLastError());
}

template <class F>
static int launch_step(const typename F::Args& w, const float* ts, int k,
                       int C, int cap, const SolveArgs& s,
                       const StepState& st, float* ys, cudaStream_t stream) {
  const cudaError_t e = cudaMemsetAsync(st.flags, 0, 2 * sizeof(int), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_step_as<F>(w, ts, k, C, cap, 0, 1, s, st, ys, stream);
}

template <class F>
static int launch_steps(const typename F::Args& w, const float* ts, int T,
                        int C, int max_steps, int steps_per_call,
                        const SolveArgs& s, const StepState& st, float* ys,
                        cudaStream_t stream) {
  const cudaError_t e =
      cudaMemsetAsync(st.flags, 0, 2 * sizeof(int) * T, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int k = 1; k < T; ++k) {
    StepState sk = st;
    sk.flags = st.flags + 2 * k;
    const int status = launch_step_as<F>(w, ts, k, C, -1, max_steps,
                                         steps_per_call, s, sk, ys, stream);
    if (status != 0) return status;
  }
  return 0;
}

// The shared memory of the forwards' blocks, in the order (DOPRI5, no
// records), (DOPRI5, records), (TSIT5, no records), (TSIT5, records); of
// the backward's, DOPRI5 then TSIT5; of the per-step solver's.  Static and
// dynamic bytes (kernel_smem), for the libraries' _smem entry points.
template <class F>
int fwd_smem(int* bytes) {
  constexpr size_t dyn = smem_bytes<F, false>();
  cudaError_t e = kernel_smem(fwd_kernel<F, Dopri5, false>(), dyn, bytes);
  if (e == cudaSuccess)
    e = kernel_smem(fwd_kernel<F, Dopri5, true>(), dyn, bytes + 1);
  if (e == cudaSuccess)
    e = kernel_smem(fwd_kernel<F, Tsit5, false>(), dyn, bytes + 2);
  if (e == cudaSuccess)
    e = kernel_smem(fwd_kernel<F, Tsit5, true>(), dyn, bytes + 3);
  return static_cast<int>(e);
}

template <class F>
int bwd_smem(int* bytes) {
  constexpr size_t dyn = smem_bytes<F, true>();
  cudaError_t e = kernel_smem(bwd_kernel<F, Dopri5>(), dyn, bytes);
  if (e == cudaSuccess)
    e = kernel_smem(bwd_kernel<F, Tsit5>(), dyn, bytes + 1);
  return static_cast<int>(e);
}

template <class F>
int step_smem(int* bytes) {
  return static_cast<int>(kernel_smem(&dopri5_step_kernel<F, Dopri5>,
                                      smem_bytes<F, false>(), bytes));
}

}  // namespace bode
