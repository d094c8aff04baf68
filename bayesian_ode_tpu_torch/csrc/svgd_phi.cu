// The SVGD direction phi with the RBF kernel, one tile of the n x n kernel
// matrix at a time, so that K never reaches device memory:
//
//   phi_i = (sum_j K_ij s_j + 2 gamma (x_i sum_j K_ij - sum_j K_ij x_j)) / n,
//   K_ij  = exp(-gamma * max(|x_i|^2 + |x_j|^2 - 2 x_i . x_j, 0)).
//
// Replaces bayesian_ode_tpu/ops/pallas_rbf.py::_phi_kernel (K8), launched
// there by svgd_phi_pallas.  The TPU walked the column tiles as a sequential
// grid axis that accumulated into the same output block; here a block owns
// kRows particle rows and a chunk of kFeat features of phi, and loops over
// the column tiles itself, so no block depends on another.  Per column tile:
//   A. the distance product x_i . x_j over all d features, kK at a time from
//      shared memory, each thread a 2 x 4 register tile of the 32 x 64 tile,
//      with |x_i|^2 and |x_j|^2 summed from the same staged values; then
//      K = expf(-gamma d2), zero for columns past n, into shared memory;
//   B. sum_j K_ij, and sum_j K_ij s_j and sum_j K_ij x_j for the block's
//      feature chunk, each thread 4 rows x 4 features in registers.
// Only the (n, d) phi rows are written.  The norm-expansion distance,
// clamped at 0, is the TPU kernel's (pallas_rbf.py:35-37) and the plain
// version's, so both compute the same function.  Full-precision expf, no
// tensor cores and no TF32.
//
// Precision.  On an ensemble clustered around one point (the SVGD path's:
// |x|^2 about 120, pairwise d2 about 4e-3) the norm expansion cancels, and
// gamma d2 turns the sums' rounding into percent errors of K.  Product A
// therefore accumulates in FP64 (a product of two FP32 values is exact
// there), and d2 is rounded to FP32 once; in FP32, its sequential sums
// over d lost to the plain version's cuBLAS and tree sums (max-rel to a
// float64 truth 5.5e-2 against 2.5e-2 at n = 4,096).  Product B, the
// exponentials and the sums are FP32.
//
// What bounds it on an H100: operations.  For n = 4,096 particles of
// d = 74 it does about n^2 (3d FMAs + one expf) = 7.6 GFLOP, about 0.11 ms
// at the 67 TFLOP/s of FP32 outside the tensor cores (product A's third at
// FP64's half rate), against 3.6 MB of inputs and outputs (about 1 us at
// 3.35 TB/s).  This first version runs both products as FMAs from shared
// memory; they are matrix work that `wgmma` could take later.
#include <cuda_runtime.h>
#include <math.h>

namespace bode {

constexpr int kRows = 32;       // particle rows a block owns
constexpr int kCols = 64;       // columns per tile of K
constexpr int kK = 16;          // features per step of the distance product
constexpr int kFeat = 128;      // features of phi a block accumulates
constexpr int kThreads = 256;
constexpr int kPadR = kRows + 4;   // row strides padded against bank
constexpr int kPadC = kCols + 4;   // conflicts, keeping float2/4 alignment

struct PhiSmem {
  double xr[kK][kPadR];         // rows' features k0..k0+kK, transposed
  double xc[kK][kPadC];         // columns' features, transposed
  double xx[kRows];             // |x_i|^2
  double yy[kCols];             // |x_j|^2
  float kt[kCols][kRows];       // the K tile, column-major
  float sc[kCols][kFeat];       // the columns' scores of the feature chunk
  float pc[kCols][kFeat];       // the columns' particles of the chunk
};

// max(v, 0) that keeps NaN, as jnp.maximum and torch.clamp_min.
__device__ __forceinline__ float clamp0(float v) {
  return v != v ? v : fmaxf(v, 0.f);
}

__global__ void __launch_bounds__(kThreads)
svgd_phi_kernel(const float* __restrict__ X, const float* __restrict__ S,
                const float* __restrict__ gamma_p, int n, int d,
                float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PhiSmem& sm = *reinterpret_cast<PhiSmem*>(smem_raw);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int f0 = blockIdx.y * kFeat;
  const float gamma = *gamma_p;

  // phase A: thread (ty, tx) holds rows 2ty, 2ty+1 and columns 4tx..4tx+3
  const int ty = tid / 16, tx = tid % 16;
  // phase B: thread (rg, fl) holds rows 4rg..4rg+3, features fl + 32q
  const int rg = tid / 32, fl = tid % 32;

  float ks[4][4], kx[4][4], ksum[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    ksum[r] = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) ks[r][q] = kx[r][q] = 0.f;
  }

  for (int col0 = 0; col0 < n; col0 += kCols) {
    // ---- A: the distance product over all d features ----
    double cr[2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) cr[a][b] = 0.0;
    double norm = 0.0;           // threads 0..31: |x_i|^2, 32..95: |x_j|^2
    for (int k0 = 0; k0 < d; k0 += kK) {
      __syncthreads();           // the previous users of xr/xc are done
      for (int e = tid; e < kRows * kK; e += kThreads) {
        const int i = e / kK, kk = e % kK;
        const int r = row0 + i, k = k0 + kk;
        sm.xr[kk][i] = (r < n && k < d) ? X[static_cast<size_t>(r) * d + k]
                                        : 0.0f;
      }
      for (int e = tid; e < kCols * kK; e += kThreads) {
        const int j = e / kK, kk = e % kK;
        const int c = col0 + j, k = k0 + kk;
        sm.xc[kk][j] = (c < n && k < d) ? X[static_cast<size_t>(c) * d + k]
                                        : 0.f;
      }
      __syncthreads();
      if (tid < kRows) {
#pragma unroll
        for (int kk = 0; kk < kK; ++kk) norm += sm.xr[kk][tid] * sm.xr[kk][tid];
      } else if (tid < kRows + kCols) {
        const int j = tid - kRows;
#pragma unroll
        for (int kk = 0; kk < kK; ++kk) norm += sm.xc[kk][j] * sm.xc[kk][j];
      }
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        const double2 a =
            *reinterpret_cast<const double2*>(&sm.xr[kk][2 * ty]);
        const double2 b0 =
            *reinterpret_cast<const double2*>(&sm.xc[kk][4 * tx]);
        const double2 b1 =
            *reinterpret_cast<const double2*>(&sm.xc[kk][4 * tx + 2]);
        const double av[2] = {a.x, a.y};
        const double bv[4] = {b0.x, b0.y, b1.x, b1.y};
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) cr[u][v] += av[u] * bv[v];
      }
    }
    if (tid < kRows) sm.xx[tid] = norm;
    else if (tid < kRows + kCols) sm.yy[tid - kRows] = norm;

    // the columns' scores and particles of this block's feature chunk
    for (int e = tid; e < kCols * kFeat; e += kThreads) {
      const int j = e / kFeat, f = e % kFeat;
      const int c = col0 + j, g = f0 + f;
      const bool ok = c < n && g < d;
      const size_t at = static_cast<size_t>(c) * d + g;
      sm.sc[j][f] = ok ? S[at] : 0.f;
      sm.pc[j][f] = ok ? X[at] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = 2 * ty + u;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int j = 4 * tx + v;
        const float d2 = clamp0(
            static_cast<float>(sm.xx[i] + sm.yy[j] - 2.0 * cr[u][v]));
        sm.kt[j][i] = (col0 + j < n) ? expf(-gamma * d2) : 0.f;
      }
    }
    __syncthreads();

    // ---- B: the weighted sums over this tile's columns ----
#pragma unroll 4
    for (int j = 0; j < kCols; ++j) {
      const float4 kv4 = *reinterpret_cast<const float4*>(&sm.kt[j][4 * rg]);
      const float kv[4] = {kv4.x, kv4.y, kv4.z, kv4.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) ksum[r] += kv[r];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float s = sm.sc[j][fl + 32 * q];
        const float p = sm.pc[j][fl + 32 * q];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ks[r][q] += kv[r] * s;
          kx[r][q] += kv[r] * p;
        }
      }
    }
  }

  const float two_gamma = 2.0f * gamma;
  const float nf = static_cast<float>(n);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = row0 + 4 * rg + r;
    if (i >= n) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int g = f0 + fl + 32 * q;
      if (g >= d) continue;
      const size_t at = static_cast<size_t>(i) * d + g;
      out[at] = (ks[r][q] + two_gamma * (X[at] * ksum[r] - kx[r][q])) / nf;
    }
  }
}

}  // namespace bode

extern "C" {

// This library has no shape baked in.
int svgd_phi_dims() { return 0; }

// phi (n, d) from particles X (n, d), scores S (n, d) and the bandwidth
// gamma (one float on the card), divided by n.  Returns cudaGetLastError()
// (or the error of raising the block's shared-memory limit).
int svgd_phi(const float* X, const float* S, const float* gamma, int n, int d,
             float* out, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(bode::PhiSmem));
  const cudaError_t e = cudaFuncSetAttribute(
      bode::svgd_phi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n + bode::kRows - 1) / bode::kRows,
                  (d + bode::kFeat - 1) / bode::kFeat);
  bode::svgd_phi_kernel<<<grid, bode::kThreads, smem, stream>>>(X, S, gamma,
                                                                 n, d, out);
  return static_cast<int>(cudaGetLastError());
}

// The shared memory of a block (dynamic): the shape check's arithmetic
// (ops/_build.py) against the build.
int svgd_phi_smem(int* bytes) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, bode::svgd_phi_kernel);
  *bytes = e == cudaSuccess
               ? static_cast<int>(a.sharedSizeBytes + sizeof(bode::PhiSmem))
               : -1;
  return static_cast<int>(e);
}

}  // extern "C"
