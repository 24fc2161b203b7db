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

// Asynchronous copies from device memory into shared memory (cp.async).
// Each thread waits for its own copies (cp_async_wait); a barrier makes them
// visible to the other threads of the block.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

// 4 bytes, or 4 zero bytes (src not read) when !valid.
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src,
                                                bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
