// Loads and stores of the float kernels' activation types (f32, bf16): every
// value is widened to f32 on load and all arithmetic runs in f32; results
// are rounded back to the activation type on store (round to nearest even,
// as a PyTorch `.to(torch.bfloat16)` does).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace xlb {

// Activation type codes passed from Python (kernels/_build.DTYPE_CODES).
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

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
  return __float2bfloat16_rn(v);
}

// Opt a kernel in to `bytes` of dynamic shared memory (above the 48 KB a
// launch gets by default); no-op below it.
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace xlb
