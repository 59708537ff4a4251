// Shared helpers for the port's CUDA kernels: element conversion between
// the storage types the wrappers accept (float, bf16, fp16) and the fp32
// the kernels compute in, plus the dtype codes of the C interface.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace vetk {

// dtype codes passed by the Python wrappers (kernels.py DTYPE_CODES).
enum DType : int { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2 };

// Returned by a launch whose TMA tensor map could not be encoded, plus the
// driver's CUresult (0 when cuTensorMapEncodeTiled itself was not found);
// above every cudaError_t.
constexpr int kTensorMapError = 100000;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half(v);
}

// x * sigmoid(x) with the fast exp and division (~2 ulp in fp32).
__device__ __forceinline__ float silu(float x) { return __fdividef(x, 1.0f + __expf(-x)); }

// log(1 + e^x) in the overflow-free form jax.nn.softplus uses.
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// Raises the dynamic shared-memory limit of `kernel` when `bytes` needs it.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace vetk
