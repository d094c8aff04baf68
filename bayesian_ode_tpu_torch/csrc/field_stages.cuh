// The stage-slot part of the field contract of the reverse sweeps
// (rk4_common.cuh: rk4_step_vjp; dopri5_kernels.cuh: bwd_sweep), and how a
// field spreads a chain's state over threads.
//
// A reverse sweep first evaluates the field at each stage point of a step
// and then takes the VJP at each of them.  A field that keeps its
// activations (the MLP field, mlp_field.cuh) declares kStageSlots and
// provides
//   stage_rhs(slot, y, f)          f at y, keeping y's activations in `slot`;
//   stage_hidden(slot, y)          the same without f (the last stage's f is
//                                  never needed);
//   stage_vjp(slot, y, cot, ybar, acc)   the VJP at the point kept in `slot`.
// Every other field (GP, spiral, FitzHugh-Nagumo) keeps nothing: the
// helpers below call its rhs and rhs_vjp.
//
// Independently, a field that spreads a chain's state over threads (the
// MLP field's: one component a lane; the GP field's per-point kernels,
// GPPoint in gp_field.cuh: one trajectory point a thread)
// declares
//   kOwn, comp(q), owner()         the state components a thread carries in
//                                  the sweep's arrays, the index of its q-th
//                                  one, and whether it writes them out.
// A field without kOwn carries all kNS components on each thread, written
// by its leader().  The fields that declare neither compute what they
// computed before the slots existed, operation for operation.  A field
// whose threads carry some real components and some mirrors (the wide
// spiral field, spiral_wide_field.cuh: lane l's q-th component is
// 32 q + l, a mirror past 2N - 1) also declares
//   owns(q)                        whether this thread writes its q-th
//                                  component out (beside owner());
// for every other field `owns` is true.
//
// The forwards (dopri5_kernels.cuh: K1, K2) spread the state only where
// the field also provides
//   norm_sums(r, sx, sy)           the error norm's sums over the chain: r
//                                  holds this thread's kOwn ratios, and sx
//                                  (sy) gets the squares of the chain's x
//                                  (y) components added in ascending n, the
//                                  same bits on each of the chain's threads
// (GPPoint, gp_field.cuh, and FHNPoint, fhn_field.cuh: one trajectory
// point a thread; MLPDopri5Fwd, mlp_field.cuh, and SpiralDopri5Fwd,
// spiral_field.cuh: one component a lane).  A field without it
// (FHNDopri5, past 32 points a chain) keeps the whole state on each of its
// threads.
//
// Last, where a block's buffers live.  A field's Smem (and a reverse
// sweep's AccSmem) sit in static shared memory, which a block may have 48
// KB of, unless the field declares
//   kDynamicSmem                   its buffers grow with a shape past that
//                                  (the GP field's, with the inducing
//                                  grid: GPPoint)
// and then in dynamic shared memory, Smem first and AccSmem after it,
// sized at launch (smem_bytes); a launcher raises the block's limit past
// 48 KB once per kernel (allow_smem), up to the 232,448 B an H100 block
// may take.  The build's shape check (ops/_build.py, check_shape) holds
// every kernel to its limit before nvcc sees the shape.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

namespace bode {

template <class F, class = void>
struct keeps_stages : std::false_type {};
template <class F>
struct keeps_stages<F, std::void_t<decltype(F::kStageSlots)>>
    : std::true_type {};

template <class F>
__device__ __forceinline__ void stage_rhs(const F& f, int slot,
                                          const float* y, float* out) {
  if constexpr (keeps_stages<F>::value)
    f.stage_rhs(slot, y, out);
  else
    f.rhs(y, out);
}

template <class F>
__device__ __forceinline__ void stage_hidden(const F& f, int slot,
                                             const float* y) {
  if constexpr (keeps_stages<F>::value) f.stage_hidden(slot, y);
}

template <class F, class Acc>
__device__ __forceinline__ void stage_vjp(const F& f, int slot,
                                          const float* y, const float* cot,
                                          float* ybar, Acc&& acc) {
  if constexpr (keeps_stages<F>::value)
    f.stage_vjp(slot, y, cot, ybar, acc);
  else
    f.rhs_vjp(y, cot, ybar, acc);
}

template <class F, class = void>
struct spreads_state : std::false_type {};
template <class F>
struct spreads_state<F, std::void_t<decltype(F::kOwn)>> : std::true_type {};

template <class F>
__host__ __device__ constexpr int own_components() {
  if constexpr (spreads_state<F>::value)
    return F::kOwn;
  else
    return F::kNS;
}

template <class F>
__device__ __forceinline__ int own_component(int q) {
  if constexpr (spreads_state<F>::value)
    return F::comp(q);
  else
    return q;
}

template <class F>
__device__ __forceinline__ bool owner() {
  if constexpr (spreads_state<F>::value)
    return F::owner();
  else
    return F::leader();
}

template <class F, class = void>
struct owns_each : std::false_type {};
template <class F>
struct owns_each<F, std::void_t<decltype(&F::owns)>> : std::true_type {};

template <class F>
__device__ __forceinline__ bool owns(int q) {
  if constexpr (owns_each<F>::value)
    return F::owns(q);
  else
    return true;
}

template <class F, class = void>
struct spreads_forward : std::false_type {};
template <class F>
struct spreads_forward<F, std::void_t<decltype(&F::norm_sums)>>
    : std::true_type {};

// The forwards' counterparts of own_components, own_component and owner.
template <class F>
__host__ __device__ constexpr int fwd_components() {
  if constexpr (spreads_forward<F>::value)
    return F::kOwn;
  else
    return F::kNS;
}

template <class F>
__device__ __forceinline__ int fwd_component(int q) {
  if constexpr (spreads_forward<F>::value)
    return F::comp(q);
  else
    return q;
}

template <class F>
__device__ __forceinline__ bool fwd_owner() {
  if constexpr (spreads_forward<F>::value)
    return F::owner();
  else
    return F::leader();
}

template <class F, class = void>
struct dynamic_smem : std::false_type {};
template <class F>
struct dynamic_smem<F, std::void_t<decltype(F::kDynamicSmem)>>
    : std::true_type {};

// AccSmem's offset after Smem in dynamic shared memory
template <class F>
__host__ __device__ constexpr size_t acc_offset() {
  constexpr size_t a = alignof(typename F::AccSmem);
  return (sizeof(typename F::Smem) + a - 1) / a * a;
}

// The dynamic shared memory of a launch over F: Smem, and AccSmem after it
// where the kernel takes cotangents (kAcc) and AccSmem holds any; 0 for a
// field with static buffers.
template <class F, bool kAcc>
constexpr size_t smem_bytes() {
  if constexpr (!dynamic_smem<F>::value) {
    return 0;
  } else if constexpr (kAcc) {
    if constexpr (std::is_empty_v<typename F::AccSmem>)
      return sizeof(typename F::Smem);
    else
      return acc_offset<F>() + sizeof(typename F::AccSmem);
  } else {
    return sizeof(typename F::Smem);
  }
}

__device__ __forceinline__ unsigned char* dynamic_smem_base() {
  extern __shared__ __align__(16) unsigned char bode_smem[];
  return bode_smem;
}

// The block's Smem and AccSmem, static or dynamic as the field says.
template <class F>
__device__ __forceinline__ typename F::Smem& block_smem() {
  if constexpr (dynamic_smem<F>::value) {
    return *reinterpret_cast<typename F::Smem*>(dynamic_smem_base());
  } else {
    __shared__ typename F::Smem sm;
    return sm;
  }
}

template <class F>
__device__ __forceinline__ typename F::AccSmem& block_acc_smem() {
  if constexpr (dynamic_smem<F>::value) {
    return *reinterpret_cast<typename F::AccSmem*>(dynamic_smem_base()
                                                   + acc_offset<F>());
  } else {
    __shared__ typename F::AccSmem acc;
    return acc;
  }
}

// Let `kernel` take `bytes` of dynamic shared memory where that passes the
// default 48 KB.  The launchers call it once per kernel and keep the
// result.
template <class K>
cudaError_t allow_smem(K* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The shared memory a block of `kernel` takes, its static bytes (as ptxas
// allocated them) and the `dynamic` bytes its launch gives it, into
// *bytes; for the libraries' <name>_smem entry points.
template <class K>
cudaError_t kernel_smem(K* kernel, size_t dynamic, int* bytes) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  *bytes = e == cudaSuccess ? static_cast<int>(a.sharedSizeBytes + dynamic)
                            : -1;
  return e;
}

}  // namespace bode
