// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel is reached through a plain C entry point (no PyTorch
// headers, so nvcc builds it in seconds) that launches on the caller's
// stream and returns cudaGetLastError(); its operator in bindings.cpp
// raises when that is not 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes shared with the operators (bindings.cpp dtype_code)
enum AktDtype { AKT_F32 = 0, AKT_BF16 = 1, AKT_I16 = 2 };

// cudaError_t values are >= 0; unsupported argument combinations report
// this instead so the wrapper can name the fault.
constexpr int AKT_BAD_ARGS = -1;

__device__ __forceinline__ float akt_to_float(float v) { return v; }
__device__ __forceinline__ float akt_to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float akt_to_float(int16_t v) {
  return static_cast<float>(v);
}

template <typename T>
__device__ __forceinline__ T akt_from_float(float v);
template <>
__device__ __forceinline__ float akt_from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 akt_from_float<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, as torch .to()
}
