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

// Bulk copies (the copy engine) into shared memory, completing on an
// mbarrier: the two copy kernels, transpose_pad.cu and
// probe_window_copy.cu.
__device__ __forceinline__ uint32_t akt_smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An mbarrier that one arrival (with its expected bytes) completes.
__device__ __forceinline__ void akt_mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   akt_smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void akt_mbar_arrive_expect_tx(uint64_t* bar,
                                                          uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          akt_smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait for the phase of `parity` to complete. A phase that never does (a
// byte count that disagrees with the copies) traps, failing the launch,
// instead of hanging the card.
__device__ __forceinline__ void akt_mbar_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(akt_smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory, counted against bar's expected bytes.
__device__ __forceinline__ void akt_bulk_load(void* dst, const void* src,
                                              uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(akt_smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(akt_smem_u32(bar))
      : "memory");
}
