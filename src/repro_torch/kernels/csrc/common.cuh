// Shared helpers of the port's CUDA kernels: f32/bf16 loads and stores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Type codes passed across the C interface (see kernels/build.py users).
enum ReproDtype { kReproF32 = 0, kReproBF16 = 1 };

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Round to nearest even, as torch's .to(torch.bfloat16) does.
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
