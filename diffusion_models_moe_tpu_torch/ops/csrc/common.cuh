// Shared helpers for the hand-written Hopper kernels (sm_90a).
//
// The kernels are bound through a plain C interface (extern "C" launchers
// taking device pointers, shapes and the caller's stream) and loaded with
// ctypes; see ops/_build.py. Each launcher returns the cudaError_t of its
// launch so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float bf2f(bf16 x) { return __bfloat162float(x); }
// round-to-nearest-even, the rounding of jnp.astype(bfloat16)
__device__ __forceinline__ bf16 f2bf(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ uint4 zero_u4() { return make_uint4(0u, 0u, 0u, 0u); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Exact (erf) GELU in f32, in the op order of the JAX kernel's _gelu_exact.
__device__ __forceinline__ float gelu_exact(float x) {
  return x * 0.5f * (1.0f + erff(x * 0.70710678118654752f));
}
