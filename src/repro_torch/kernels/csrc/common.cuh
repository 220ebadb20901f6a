// Helpers shared by the port's CUDA kernels: element loads in float32
// from float32 or bfloat16 storage, stores back, dtype codes matching
// the Python wrappers, warp reductions, the FFN activations and the
// exported error-string entry point.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// dtype codes passed by the wrappers (repro_torch/kernels/_common.py)
#define REPRO_F32 0
#define REPRO_BF16 1

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the FFN activations: silu, and gelu in its tanh form (jax.nn.gelu's
// default)
__device__ __forceinline__ float silu_f(float g) {
  return g / (1.f + expf(-g));
}

__device__ __forceinline__ float gelu_tanh_f(float g) {
  const float c = 0.7978845608028654f;   // sqrt(2 / pi)
  return 0.5f * g * (1.f + tanhf(c * (g + 0.044715f * g * g * g)));
}

#define REPRO_EXPORT_ERROR_STRING                                  \
  extern "C" const char* repro_error_string(int status) {          \
    return cudaGetErrorString(static_cast<cudaError_t>(status));   \
  }
