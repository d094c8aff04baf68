// The SVGD direction phi with the RBF kernel, one tile of the n x n kernel
// matrix at a time, so that K never reaches device memory:
//
//   phi_i = (sum_j K_ij s_j + 2 gamma (x_i sum_j K_ij - sum_j K_ij x_j)) / n,
//   K_ij  = exp(-gamma * max(|x_i|^2 + |x_j|^2 - 2 x_i . x_j, 0)).
//
// Replaces bayesian_ode_tpu/ops/pallas_rbf.py::_phi_kernel (K8), launched
// there by svgd_phi_pallas.  The TPU walked the column tiles as a sequential
// grid axis that accumulated into the same output block.  Here the grid is
// (row tiles, S column splits, feature chunks): a block owns kRows particle
// rows, a chunk of up to 96 features of phi and a contiguous range of
// column tiles, and writes its partial sums sum_j K_ij, sum_j K_ij s_j and
// sum_j K_ij (x_j - c) to a workspace [S, n, 2d + 1]; svgd_phi_combine_kernel
// adds the S partials in the order 0..S-1 and writes phi.  No atomics: the
// same inputs give the same bits.  S is picked at launch from n and the
// card's SM count, for about one wave of resident blocks (S = 1 where the
// row tiles alone fill the card).
//
// Per column tile of kCols columns, up to d = 96 (one feature chunk): the
// block stages the columns' centred particles and scores of its chunk once
// (its rows' centred particles stay in shared memory from the start), then
//   A. the distance product over the d features, each thread a 4 x 2
//      register tile of the kRows x kCols tile, with |a_i|^2 and |b_j|^2
//      summed from the same staged values; K = expf(-gamma d2), zero for
//      columns past n, into shared memory, and its row sums added across
//      the 16 lanes of a row quad by a shuffle butterfly;
//   B. sum_j K_ij s_j and sum_j K_ij b_j over the block's feature chunk:
//      warp w holds rows 8w..8w+7, lane l the features l + 32q (q < kFq),
//      8 x kFq x 2 sums in registers; a warp reads each column's 8 K values
//      as two broadcast float4 loads and 32 consecutive scores and
//      particles a feature: 48 FMAs a lane for 8 loads at kFq = 3.
// Four barriers a tile.  Past 96 features the distance product walks the
// other chunks first, restaging the rows with each, and ends on the
// block's own, whose columns product B then reads.
//
// Centring, FP32 throughout.  On an ensemble clustered around one point
// (the SVGD path's: |x|^2 about 120, pairwise d2 about 4e-3) the norm
// expansion cancels, and gamma d2 turns its rounding into percent errors
// of K.  Both d2 and the gradient term are translation-invariant, so every
// particle is staged as a = x - c, with c = x_row0, the row tile's first
// particle (it exists for the ragged last tile too; all column splits of a
// tile share it, so their partial sums add):
//   d2 = max(|a_i|^2 + |b_j|^2 - 2 a_i . b_j, 0),
//   x_i sum_j K_ij - sum_j K_ij x_j = a_i sum_j K_ij - sum_j K_ij b_j.
// In a tile the centred values are of the size of the ensemble's spread,
// so the expansion does not cancel in FP32 (on that ensemble on an H100,
// 1.2e-6 max-rel to float64 at n = 4,096, where the uncentred float32
// matmul form is 2.5e-2 off).  Full-precision expf, no tensor cores, no
// TF32, no fast math.
//
// What bounds it on an H100: operations.  For n = 4,096 particles of
// d = 74 it does about n^2 (3d FMAs + one expf) = 7.6 GFLOP, about 0.11 ms
// at the 67 TFLOP/s of FP32 outside the tensor cores, against 3.6 MB of
// inputs and outputs (about 1 us at 3.35 TB/s).  The partials add
// S n (2d + 1) floats written and read once (9.8 MB at S = 4).
#include <cuda_runtime.h>
#include <math.h>

namespace bode {

constexpr int kRows = 32;            // particle rows a block owns
constexpr int kThreads = 4 * kRows;  // product B: a warp per 8 rows
constexpr int kCols = 32;            // columns per tile of K
constexpr int kMaxFq = 3;            // features a lane: chunks of up to 96
constexpr int kChunk = 32 * kMaxFq;
constexpr int kMinBlocks = 4;        // at most 128 registers
constexpr int kPadR = kRows + 4;     // strides padded against bank
constexpr int kPadF = kChunk + 1;    // conflicts (kPadR keeps float4s aligned)
constexpr int kCombineThreads = 256;

struct PhiSmem {
  float xr[kChunk][kPadR];      // the rows' centred features, transposed
  float pc[kCols][kPadF];       // the columns' centred features of a chunk
  float sc[kCols][kChunk];      // the columns' scores of the block's chunk
  float kt[kCols][kPadR];       // the K tile, column-major
  float xx[kRows];              // |a_i|^2
  float yy[kCols];              // |b_j|^2
};

// max(v, 0) that keeps NaN, as jnp.maximum and torch.clamp_min.
__device__ __forceinline__ float clamp0(float v) {
  return v != v ? v : fmaxf(v, 0.f);
}

// The rows' centred features a0..a0+kChunk (zero past n and d).
__device__ __forceinline__ void stage_rows(PhiSmem& sm, const float* X,
                                           const float* c, int row0, int a0,
                                           int n, int d) {
  for (int e = threadIdx.x; e < kRows * kChunk; e += kThreads) {
    const int i = e / kChunk, k = e % kChunk;
    const int r = row0 + i, g = a0 + k;
    sm.xr[k][i] = (r < n && g < d) ? X[static_cast<size_t>(r) * d + g] - c[g]
                                   : 0.f;
  }
}

template <int kFq>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
svgd_phi_kernel(const float* __restrict__ X, const float* __restrict__ S,
                const float* __restrict__ gamma_p, int n, int d,
                int tiles_per_split, float* __restrict__ work) {
  __shared__ __align__(16) PhiSmem sm;
  constexpr int kF = 32 * kFq;  // the block's feature chunk
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int split = blockIdx.y;
  const int chunk = blockIdx.z, chunks = gridDim.z;
  const float gamma = *gamma_p;
  const float* c = X + static_cast<size_t>(row0) * d;  // the tile's centre

  // A: thread (ty, tx) holds rows 4ty..4ty+3 and columns 2tx, 2tx+1
  const int ty = tid / 16, tx = tid % 16;
  // B: warp w holds rows 8w..8w+7, lane l the features l + 32q
  const int w = tid / 32, l = tid % 32;

  float ks[8][kFq], kx[8][kFq], ksum[4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < kFq; ++q) ks[r][q] = kx[r][q] = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u) ksum[u] = 0.f;

  if (chunks == 1) {             // the rows and their norms, once
    stage_rows(sm, X, c, row0, 0, n, d);
    __syncthreads();
    if (tid < kRows) {
      float norm = 0.f;
      for (int k = 0; k < d; ++k) norm += sm.xr[k][tid] * sm.xr[k][tid];
      sm.xx[tid] = norm;
    }
  }
  const int tiles = (n + kCols - 1) / kCols;
  const int t_end = min(tiles, (split + 1) * tiles_per_split);
  for (int t = split * tiles_per_split; t < t_end; ++t) {
    const int col0 = t * kCols;
    // ---- A: the centred distance product, the block's chunk last ----
    float cr[4][2];
#pragma unroll
    for (int u = 0; u < 4; ++u) cr[u][0] = cr[u][1] = 0.f;
    float norm = 0.f;            // threads 0..kRows-1: |a_i|^2 (past one
                                 // chunk), then |b_j|^2
    for (int step = 1; step <= chunks; ++step) {
      const int a = (chunk + step) % chunks, a0 = a * kChunk;
      const int width = min(kChunk, d - a0);
      __syncthreads();           // the previous users of the buffers are done
      if (chunks > 1) stage_rows(sm, X, c, row0, a0, n, d);
      for (int e = tid; e < kCols * kF; e += kThreads) {
        const int j = e / kF, f = e % kF;
        const int col = col0 + j, g = a0 + f;
        const bool ok = col < n && g < d;
        const size_t at = static_cast<size_t>(col) * d + g;
        sm.pc[j][f] = ok ? X[at] - c[g] : 0.f;
        if (step == chunks) sm.sc[j][f] = ok ? S[at] : 0.f;
      }
      __syncthreads();
      if (tid < kRows) {
        if (chunks > 1)
          for (int k = 0; k < width; ++k)
            norm += sm.xr[k][tid] * sm.xr[k][tid];
      } else if (tid < kRows + kCols) {
        const int j = tid - kRows;
        for (int k = 0; k < width; ++k) norm += sm.pc[j][k] * sm.pc[j][k];
      }
#pragma unroll 4
      for (int k = 0; k < width; ++k) {
        const float4 x4 = *reinterpret_cast<const float4*>(&sm.xr[k][4 * ty]);
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
        const float b0 = sm.pc[2 * tx][k], b1 = sm.pc[2 * tx + 1][k];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          cr[u][0] += xv[u] * b0;
          cr[u][1] += xv[u] * b1;
        }
      }
    }
    if (tid < kRows) {
      if (chunks > 1) sm.xx[tid] = norm;
    } else if (tid < kRows + kCols) sm.yy[tid - kRows] = norm;
    __syncthreads();
    float kv[4][2];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int j = 2 * tx + v;
        const float d2 =
            clamp0(sm.xx[4 * ty + u] + sm.yy[j] - 2.f * cr[u][v]);
        kv[u][v] = (col0 + j < n) ? expf(-gamma * d2) : 0.f;
      }
    }
#pragma unroll
    for (int v = 0; v < 2; ++v)
      *reinterpret_cast<float4*>(&sm.kt[2 * tx + v][4 * ty]) =
          make_float4(kv[0][v], kv[1][v], kv[2][v], kv[3][v]);
    // the rows' sums of this tile: over the 16 lanes that share ty
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float s = kv[u][0] + kv[u][1];
#pragma unroll
      for (int o = 8; o > 0; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
      ksum[u] += s;
    }
    __syncthreads();

    // ---- B: the weighted sums over this tile's columns ----
#pragma unroll 4
    for (int j = 0; j < kCols; ++j) {
      const float4 ka = *reinterpret_cast<const float4*>(&sm.kt[j][8 * w]);
      const float4 kb = *reinterpret_cast<const float4*>(&sm.kt[j][8 * w + 4]);
      const float kr[8] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int q = 0; q < kFq; ++q) {
        const float s = sm.sc[j][l + 32 * q];
        const float p = sm.pc[j][l + 32 * q];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          ks[r][q] += kr[r] * s;
          kx[r][q] += kr[r] * p;
        }
      }
    }
  }

  // this split's partials: [ks (d) | kx (d) | ksum] a row
  const size_t stride = 2 * static_cast<size_t>(d) + 1;
  const int f0 = chunk * kF;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = row0 + 8 * w + r;
    if (i >= n) continue;
    float* row = work + (static_cast<size_t>(split) * n + i) * stride;
#pragma unroll
    for (int q = 0; q < kFq; ++q) {
      const int g = f0 + l + 32 * q;
      if (g >= d) continue;
      row[g] = ks[r][q];
      row[d + g] = kx[r][q];
    }
  }
  if (chunk == 0 && tx == 0) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = row0 + 4 * ty + u;
      if (i < n)
        work[(static_cast<size_t>(split) * n + i) * stride + 2 * d] = ksum[u];
    }
  }
}

// phi from the S partials, added in the order 0..S-1: one thread an
// element of phi.
__global__ void __launch_bounds__(kCombineThreads)
svgd_phi_combine_kernel(const float* __restrict__ X,
                        const float* __restrict__ gamma_p,
                        const float* __restrict__ work, int splits, int n,
                        int d, float* __restrict__ out) {
  const size_t e = static_cast<size_t>(blockIdx.x) * kCombineThreads +
                   threadIdx.x;
  if (e >= static_cast<size_t>(n) * d) return;
  const int i = static_cast<int>(e / d), g = static_cast<int>(e % d);
  const size_t stride = 2 * static_cast<size_t>(d) + 1;
  float ks = 0.f, kx = 0.f, ksum = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float* row = work + (static_cast<size_t>(s) * n + i) * stride;
    ks += row[g];
    kx += row[d + g];
    ksum += row[2 * d];
  }
  const int row0 = i / kRows * kRows;
  const float a = X[e] - X[static_cast<size_t>(row0) * d + g];
  const float two_gamma = 2.0f * *gamma_p;
  out[e] = (ks + two_gamma * (a * ksum - kx)) / static_cast<float>(n);
}

// Features a lane: d rounded up to a multiple of 32, at most 96.
inline int lane_features(int d) { return d > 64 ? 3 : d > 32 ? 2 : 1; }

template <int kFq>
cudaError_t launch(const float* X, const float* S, const float* gamma, int n,
                   int d, int splits, float* work, float* out,
                   cudaStream_t stream) {
  const int tiles = (n + kCols - 1) / kCols;
  const int per = (tiles + splits - 1) / splits;
  const dim3 grid((n + kRows - 1) / kRows, splits,
                  (d + 32 * kFq - 1) / (32 * kFq));
  svgd_phi_kernel<kFq><<<grid, kThreads, 0, stream>>>(X, S, gamma, n, d, per,
                                                      work);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t total = static_cast<size_t>(n) * d;
  const unsigned blocks =
      static_cast<unsigned>((total + kCombineThreads - 1) / kCombineThreads);
  svgd_phi_combine_kernel<<<blocks, kCombineThreads, 0, stream>>>(
      X, gamma, work, splits, n, d, out);
  return cudaGetLastError();
}

template <int kFq>
cudaError_t splits_for(int n, int d, int* splits) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, svgd_phi_kernel<kFq>, kThreads, 0);
  if (e != cudaSuccess) return e;
  const long long tiles = (n + kCols - 1) / kCols;
  const long long others = static_cast<long long>((n + kRows - 1) / kRows) *
                           ((d + 32 * kFq - 1) / (32 * kFq));
  // about one wave of resident blocks, each split at least one tile
  const long long want = static_cast<long long>(per_sm) * sms / others;
  const long long s = want < 1 ? 1 : want > tiles ? tiles : want;
  const long long per = (tiles + s - 1) / s;
  *splits = static_cast<int>((tiles + per - 1) / per);
  return cudaSuccess;
}

}  // namespace bode

extern "C" {

// This library has no shape baked in.
int svgd_phi_dims() { return 0; }

// The column splits S of a launch at n particles of width d on the current
// device (one int), for the caller's workspace of S * n * (2d + 1) floats.
int svgd_phi_splits(int n, int d, int* splits) {
  switch (bode::lane_features(d)) {
    case 1: return static_cast<int>(bode::splits_for<1>(n, d, splits));
    case 2: return static_cast<int>(bode::splits_for<2>(n, d, splits));
    default: return static_cast<int>(bode::splits_for<3>(n, d, splits));
  }
}

// phi (n, d) from particles X (n, d), scores S (n, d) and the bandwidth
// gamma (one float on the card), divided by n, through `splits` column
// splits (svgd_phi_splits) and the caller's workspace `work` of
// splits * n * (2d + 1) floats.  Returns cudaGetLastError() of the first
// launch that failed.
int svgd_phi(const float* X, const float* S, const float* gamma, int n, int d,
             int splits, float* work, float* out, cudaStream_t stream) {
  switch (bode::lane_features(d)) {
    case 1:
      return static_cast<int>(
          bode::launch<1>(X, S, gamma, n, d, splits, work, out, stream));
    case 2:
      return static_cast<int>(
          bode::launch<2>(X, S, gamma, n, d, splits, work, out, stream));
    default:
      return static_cast<int>(
          bode::launch<3>(X, S, gamma, n, d, splits, work, out, stream));
  }
}

// The shared memory of a block of each kernel (static, as ptxas allocated
// it): the three feature-chunk instances of svgd_phi_kernel, then the
// combine; the shape check's arithmetic (ops/_build.py) against the build.
int svgd_phi_smem(int* bytes) {
  const void* kernels[] = {
      reinterpret_cast<const void*>(bode::svgd_phi_kernel<1>),
      reinterpret_cast<const void*>(bode::svgd_phi_kernel<2>),
      reinterpret_cast<const void*>(bode::svgd_phi_kernel<3>),
      reinterpret_cast<const void*>(bode::svgd_phi_combine_kernel)};
  for (int k = 0; k < 4; ++k) {
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(&a, kernels[k]);
    if (e != cudaSuccess) return static_cast<int>(e);
    bytes[k] = static_cast<int>(a.sharedSizeBytes);
  }
  return 0;
}

}  // extern "C"
