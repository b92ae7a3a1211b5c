// Device helpers shared by the kernels of this directory (the paged reads
// and the flash forward): element conversions to f32, stores from f32, a
// pool's output type, and the dynamic shared-memory opt-in. Each
// translation unit gets its own copy (anonymous namespace).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kDefaultSmem = 48 * 1024;  // above this, opt in per kernel

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// The output type of a pool: the pool's own, f32 for the int8 pool.
template <typename KV>
using OutOf = typename std::conditional<std::is_same<KV, int8_t>::value, float, KV>::type;

// Allows `kernel` `bytes` of dynamic shared memory when that exceeds the
// default 48 KB (a launch asking for more without it is refused).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace
