// Shared helpers of the port's CUDA kernels: dtype codes and the only
// float <-> bf16 conversions the kernels use (the intrinsics, which round
// to nearest even exactly as PyTorch does).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes shared with the Python wrappers (ops/_cuda.py DTYPE_CODES)
#define EDS_DTYPE_F32 0
#define EDS_DTYPE_BF16 1
// returned for a shape or dtype the kernels do not take; the wrappers
// check first, so this only guards against a caller bypassing them
#define EDS_ERR_UNSUPPORTED 1000

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Message for a status code returned by a launcher (one definition per
// shared library: each .cu file is built into its own library).
extern "C" const char* eds_error_string(int code) {
  if (code == EDS_ERR_UNSUPPORTED) return "unsupported shape or dtype";
  return cudaGetErrorString((cudaError_t)code);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
