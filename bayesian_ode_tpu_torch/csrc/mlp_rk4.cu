// Fixed-grid rk4 (3/8 rule) trajectories of the MLP field and their
// gradient, one warp per chain and one state component a lane
// (mlp_field.cuh says why).
//
// Replaces two TPU kernels of bayesian_ode_tpu/ops/mlp_rk4.py:
//   mlp_rk4_fwd: _make_fwd_kernel (K6), the T-1 steps on the output grid,
//                storing the whole trajectory;
//   mlp_rk4_bwd: _make_bwd_kernel (K7), the reverse sweep with the four
//                stages recomputed per step and the layer VJPs, returning
//                the 9 weight cotangents (here in the layer-list layout)
//                and the per-chain x0 cotangent.
// The TPU kernels compute the layer products in their own body; so do
// these, with no library matmul, in full FP32 on the CUDA cores.
//
// What bounds them on an H100: the MIO pipe (shuffles and shared-memory
// instructions) and then the FP32 FMAs of the H x H products, over a
// serial chain of field evaluations per chain; bytes are small (the
// weights once per chain, a trajectory row per step).  10,112 chains are
// 10,112 warps in blocks of 4.
//
// K6's design: lane i < 2N carries component i of the step's arrays
// (rk4_step<1>), so a lane holds 10 floats of them, not 10 x 2N, and
// W2's column stays in the lane's registers (MLPField<0>): an evaluation
// gathers the point through the warp's shared copy and leaves f_i on lane
// i, with no W2 loads and no broadcast of f.  Every sum keeps the order
// of one chain's loop, so the trajectories do not depend on how the state
// is spread.  A warp's buffer is 688 B; 96 registers, 20 warps an SM
// (kFwdMinBlocks).
//
// Past H = 32 or N = 16 the same steps and sweeps run on
// mlp_wide_field.cuh's field (one warp and block a chain, W2 in the warp's
// buffer, W2bar in shared memory, the buffers dynamic): the second pair of
// kernels below.
//
// K7's design (mlp_field.cuh has the field's): a step recomputes its three
// stage evaluations and the hidden layer at u4, keeping each stage point's
// activations in a slot of the warp's shared buffer, so the four VJPs
// compute no hidden layer: 4 hidden passes a step, not 7.  The per-step
// arrays (stage points, stage cotangents) are distributed over the warp
// as in K6; with W2 in shared memory, a lane's 8 weights and 40 weight
// cotangents fit in 128 registers, 16 warps an SM (__launch_bounds__
// holds it there; the rk4 loop kept on every lane took 255 registers, 8
// warps).  A warp's buffer is 9,968 B at N=5, H=32.
#include "mlp_field.cuh"
#include "rk4_common.cuh"

#if !BODE_MLP_WIDE
namespace bode {

__global__ void __launch_bounds__(32 * kFwdWarps, kFwdMinBlocks)
mlp_rk4_fwd_kernel(const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ w2, const float* __restrict__ b2,
                   const float* __restrict__ w3, const float* __restrict__ b3,
                   const float* __restrict__ x0,
                   const float* __restrict__ dts, int C, int T,
                   float* __restrict__ ys) {
  __shared__ MLPFwdBuf buf[kFwdWarps];
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kFwdWarps + (threadIdx.x >> 5);
  if (c >= C) return;                    // whole warps leave together
  MLPField<0> fld;
  fld.b = &buf[threadIdx.x >> 5];
  fld.lane = lane;
  mlp_load(fld.w, c, lane, w1, b1, w2, b2, w3, b3);

  // this lane's state component (lanes past 2N mirror the last one)
  const int i = lane < kMNS ? lane : kMNS - 1;
  float y[1] = {x0[i]}, y1[1];
  if (lane < kMNS) ys[static_cast<size_t>(c) * kMNS + lane] = y[0];
  for (int t = 0; t < T - 1; ++t) {
    rk4_step<1>(fld, y, dts[t], y1);
    y[0] = y1[0];
    if (lane < kMNS)
      ys[(static_cast<size_t>(t + 1) * C + c) * kMNS + lane] = y[0];
  }
}

__global__ void __launch_bounds__(kMLPBlock, kBwdMinBlocks)
mlp_rk4_bwd_kernel(const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ w2, const float* __restrict__ b2,
                   const float* __restrict__ w3, const float* __restrict__ b3,
                   const float* __restrict__ dts,
                   const float* __restrict__ ys, const float* __restrict__ g,
                   int C, int T, float* __restrict__ gw1,
                   float* __restrict__ gb1, float* __restrict__ gw2,
                   float* __restrict__ gb2, float* __restrict__ gw3,
                   float* __restrict__ gb3, float* __restrict__ lbar) {
  __shared__ MLPBuf<4> buf[kWarpsPerBlock];   // slots: p, u2, u3, u4
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * kWarpsPerBlock + warp;
  if (c >= C) return;
  MLPField<4> fld;
  fld.b = &buf[warp];
  fld.lane = lane;
  mlp_load(fld.w, c, lane, w1, b1, w2, b2, w3, b3);
  fld.keep_w2();
  MLPUnit acc;
  mlp_zero(acc);

  // this lane's state component (lanes past 2N mirror the last one)
  const int i = lane < kMNS ? lane : kMNS - 1;
  float l[1] = {0.f}, p[1];
  for (int t = T - 2; t >= 0; --t) {
    l[0] = l[0] + g[(static_cast<size_t>(t + 1) * C + c) * kMNS + i];
    p[0] = ys[(static_cast<size_t>(t) * C + c) * kMNS + i];
    rk4_step_vjp<1>(fld, p, dts[t], l, acc);
  }
  // x0's own observation term
  if (lane < kMNS)
    lbar[static_cast<size_t>(c) * kMNS + lane] =
        l[0] + g[static_cast<size_t>(c) * kMNS + lane];
  mlp_store(acc, c, lane, gw1, gb1, gw2, gb2, gw3, gb3);
}

}  // namespace bode

extern "C" {

// ys (T, C, N, 2) from the layer list w1 (C, 2, H), b1 (C, H), w2 (C, H, H),
// b2 (C, H), w3 (C, H, 2), b3 (C, 2), x0 (N, 2) shared, dts (T-1,).
// Returns cudaGetLastError().
int mlp_rk4_fwd(const float* w1, const float* b1, const float* w2,
                const float* b2, const float* w3, const float* b3,
                const float* x0, const float* dts, int C, int T, float* ys,
                cudaStream_t stream) {
  const dim3 grid((C + bode::kFwdWarps - 1) / bode::kFwdWarps);
  bode::mlp_rk4_fwd_kernel<<<grid, 32 * bode::kFwdWarps, 0, stream>>>(
      w1, b1, w2, b2, w3, b3, x0, dts, C, T, ys);
  return static_cast<int>(cudaGetLastError());
}

// The weight cotangents in the layout of the weights, and lbar (C, N, 2),
// the per-chain x0 cotangent including g[0], from the trajectory ys and
// its cotangent g, both (T, C, N, 2).  Returns cudaGetLastError().
int mlp_rk4_bwd(const float* w1, const float* b1, const float* w2,
                const float* b2, const float* w3, const float* b3,
                const float* dts, const float* ys, const float* g, int C,
                int T, float* gw1, float* gb1, float* gw2, float* gb2,
                float* gw3, float* gb3, float* lbar, cudaStream_t stream) {
  const dim3 grid((C + bode::kWarpsPerBlock - 1) / bode::kWarpsPerBlock);
  bode::mlp_rk4_bwd_kernel<<<grid, bode::kMLPBlock, 0, stream>>>(
      w1, b1, w2, b2, w3, b3, dts, ys, g, C, T, gw1, gb1, gw2, gb2, gw3,
      gb3, lbar);
  return static_cast<int>(cudaGetLastError());
}

// The shared memory of a block of K6 and of K7 (static): the shape check's
// arithmetic (ops/_build.py) against the build.
int mlp_rk4_smem(int* bytes) {
  cudaError_t e = bode::kernel_smem(bode::mlp_rk4_fwd_kernel, 0, bytes);
  if (e == cudaSuccess)
    e = bode::kernel_smem(bode::mlp_rk4_bwd_kernel, 0, bytes + 1);
  return static_cast<int>(e);
}

}  // extern "C"
#else  // BODE_MLP_WIDE: mlp_wide_field.cuh, one chain a block
namespace bode {

// K6 and K7 past H = 32 or N = 16: the same steps and sweeps as above on
// MLPWide (W2 by rows in the warp's buffer, kMU units and kMOwn state
// components a lane), one warp a block, the buffers in dynamic shared
// memory: the forward's MLPWideFwdBuf, the sweep's MLPWideBuf<4> and W2bar
// after it.
constexpr size_t kWideFwdSmem = sizeof(MLPWideFwdBuf);
constexpr size_t kWideBwdSmem = sizeof(MLPWideBuf<4>) + sizeof(MLPWideW2bar);

__global__ void __launch_bounds__(32)
mlp_rk4_fwd_kernel(const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ w2, const float* __restrict__ b2,
                   const float* __restrict__ w3, const float* __restrict__ b3,
                   const float* __restrict__ x0,
                   const float* __restrict__ dts, int C, int T,
                   float* __restrict__ ys) {
  auto& buf = *reinterpret_cast<MLPWideFwdBuf*>(dynamic_smem_base());
  const int lane = threadIdx.x;
  const int c = blockIdx.x;
  if (c >= C) return;
  MLPWide<0> fld;
  fld.b = &buf;
  fld.lane = lane;
  mlp_wide_load(fld.w, buf.w2r, c, lane, w1, b1, w2, b2, w3, b3);

  const bool own = mlp_owner(lane);
  float y[kMOwn], y1[kMOwn];
#pragma unroll
  for (int q = 0; q < kMOwn; ++q) {
    y[q] = x0[mlp_comp(lane, q)];
    if (own) ys[static_cast<size_t>(c) * kMNS + mlp_comp(lane, q)] = y[q];
  }
  for (int t = 0; t < T - 1; ++t) {
    rk4_step<kMOwn>(fld, y, dts[t], y1);
#pragma unroll
    for (int q = 0; q < kMOwn; ++q) {
      y[q] = y1[q];
      if (own)
        ys[(static_cast<size_t>(t + 1) * C + c) * kMNS + mlp_comp(lane, q)] =
            y[q];
    }
  }
}

__global__ void __launch_bounds__(32)
mlp_rk4_bwd_kernel(const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ w2, const float* __restrict__ b2,
                   const float* __restrict__ w3, const float* __restrict__ b3,
                   const float* __restrict__ dts,
                   const float* __restrict__ ys, const float* __restrict__ g,
                   int C, int T, float* __restrict__ gw1,
                   float* __restrict__ gb1, float* __restrict__ gw2,
                   float* __restrict__ gb2, float* __restrict__ gw3,
                   float* __restrict__ gb3, float* __restrict__ lbar) {
  unsigned char* smem = dynamic_smem_base();
  auto& buf = *reinterpret_cast<MLPWideBuf<4>*>(smem);   // slots: p, u2-u4
  const int lane = threadIdx.x;
  const int c = blockIdx.x;
  if (c >= C) return;
  MLPWide<4> fld;
  fld.b = &buf;
  fld.lane = lane;
  mlp_wide_load(fld.w, buf.w2r, c, lane, w1, b1, w2, b2, w3, b3);
  MLPWideAcc acc = mlp_wide_acc(
      *reinterpret_cast<MLPWideW2bar*>(smem + sizeof(MLPWideBuf<4>)), lane);

  float l[kMOwn], p[kMOwn];
#pragma unroll
  for (int q = 0; q < kMOwn; ++q) l[q] = 0.f;
  for (int t = T - 2; t >= 0; --t) {
#pragma unroll
    for (int q = 0; q < kMOwn; ++q) {
      const int i = mlp_comp(lane, q);
      l[q] = l[q] + g[(static_cast<size_t>(t + 1) * C + c) * kMNS + i];
      p[q] = ys[(static_cast<size_t>(t) * C + c) * kMNS + i];
    }
    rk4_step_vjp<kMOwn>(fld, p, dts[t], l, acc);
  }
  // x0's own observation term
  if (mlp_owner(lane)) {
#pragma unroll
    for (int q = 0; q < kMOwn; ++q) {
      const size_t i = static_cast<size_t>(c) * kMNS + mlp_comp(lane, q);
      lbar[i] = l[q] + g[i];
    }
  }
  mlp_wide_store(acc, c, lane, gw1, gb1, gw2, gb2, gw3, gb3);
}

// The launches raise the kernels' shared-memory limit once each; static
// (internal linkage) for the reason dopri5_kernels.cuh's launchers are.
static cudaError_t allow_fwd() {
  static const cudaError_t e = allow_smem(mlp_rk4_fwd_kernel, kWideFwdSmem);
  return e;
}
static cudaError_t allow_bwd() {
  static const cudaError_t e = allow_smem(mlp_rk4_bwd_kernel, kWideBwdSmem);
  return e;
}

}  // namespace bode

extern "C" {

int mlp_rk4_fwd(const float* w1, const float* b1, const float* w2,
                const float* b2, const float* w3, const float* b3,
                const float* x0, const float* dts, int C, int T, float* ys,
                cudaStream_t stream) {
  const cudaError_t e = bode::allow_fwd();
  if (e != cudaSuccess) return static_cast<int>(e);
  bode::mlp_rk4_fwd_kernel<<<C, 32, bode::kWideFwdSmem, stream>>>(
      w1, b1, w2, b2, w3, b3, x0, dts, C, T, ys);
  return static_cast<int>(cudaGetLastError());
}

int mlp_rk4_bwd(const float* w1, const float* b1, const float* w2,
                const float* b2, const float* w3, const float* b3,
                const float* dts, const float* ys, const float* g, int C,
                int T, float* gw1, float* gb1, float* gw2, float* gb2,
                float* gw3, float* gb3, float* lbar, cudaStream_t stream) {
  const cudaError_t e = bode::allow_bwd();
  if (e != cudaSuccess) return static_cast<int>(e);
  bode::mlp_rk4_bwd_kernel<<<C, 32, bode::kWideBwdSmem, stream>>>(
      w1, b1, w2, b2, w3, b3, dts, ys, g, C, T, gw1, gb1, gw2, gb2, gw3,
      gb3, lbar);
  return static_cast<int>(cudaGetLastError());
}

int mlp_rk4_smem(int* bytes) {
  cudaError_t e =
      bode::kernel_smem(bode::mlp_rk4_fwd_kernel, bode::kWideFwdSmem, bytes);
  if (e == cudaSuccess)
    e = bode::kernel_smem(bode::mlp_rk4_bwd_kernel, bode::kWideBwdSmem,
                          bytes + 1);
  return static_cast<int>(e);
}

}  // extern "C"
#endif  // BODE_MLP_WIDE

extern "C" {

// Dimensions this library was built for.
int mlp_rk4_dims(int* n_points, int* hidden) {
  *n_points = bode::kMN;
  *hidden = bode::kH;
  return 0;
}

}  // extern "C"
