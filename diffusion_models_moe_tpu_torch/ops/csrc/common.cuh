// Shared helpers for the hand-written Hopper kernels (sm_90a).
//
// The kernels are bound through a plain C interface (extern "C" launchers
// taking device pointers, shapes and the caller's stream) and loaded with
// ctypes; see ops/_build.py. Each launcher returns the cudaError_t of its
// launch so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float bf2f(bf16 x) { return __bfloat162float(x); }
// round-to-nearest-even, the rounding of jnp.astype(bfloat16)
__device__ __forceinline__ bf16 f2bf(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ uint4 zero_u4() { return make_uint4(0u, 0u, 0u, 0u); }

// 16 bytes from global to shared memory without passing through registers
// (Ampere's cp.async, L2 only); zeros when `pred` is false. Copies are
// grouped by cp_async_commit and awaited by cp_async_wait<N> (at most N of
// the newest groups still in flight).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Exact (erf) GELU in f32, in the op order of the JAX kernel's _gelu_exact.
__device__ __forceinline__ float gelu_exact(float x) {
  return x * 0.5f * (1.0f + erff(x * 0.70710678118654752f));
}
