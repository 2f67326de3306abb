// Kernel A — half-band decimate + reflect pad: one octave step of the CQT
// cascade, from one octave's padded stream to the next octave's.
//
// Replaces audio_key_estimation_tpu/ops/cqt_pallas.py::_cascade_pad_tm
// (the fused TPU cascade) together with its _reflect_fix patch.
//
// Computes, for each clip b and each row r of the output buffer,
//   out[r] = dec[reflect(r - head_out)]  for r < L_out + 2*head_out + 1
//   out[r] = 0                           beyond (alignment tail)
//   dec[k] = sum_j taps[j] * x[2k + j - 24], x zero outside [0, L_in)
// where x is the interior of the input buffer (it starts at head_in) and
// reflect() is numpy's 'reflect' (repeated for streams shorter than the
// pad), so the reflect rows equal jnp.pad(..., mode="reflect") exactly.
// Accumulates in float32; int16 PCM (octave 0 -> 1) arrives with 1/32768
// already folded into the taps; output is float32 or bfloat16.
//
// What bounds it on the H100: by its bytes, memory bandwidth — it reads
// each stream once and writes the next once, against 49 FMAs per output.
// As written, shared-memory loads bound it first: each output reads 49
// staged samples at stride 2 (a 2-way bank conflict), which holds the
// whole cascade to about 0.5 TB/s on an H100 at 700 W (PERF.md); an
// even/odd split of the staged samples, or several outputs per thread,
// is the next step. Design: batch-major rows (clip = blockIdx.y), one
// 256-output tile per block; an interior tile stages its 2*256+48 input
// samples in shared memory once (coalesced), so every input sample is
// read from device memory once; the few tiles touching the reflect rows
// compute each output straight from device memory. The TPU's time-major
// (L, B) layout and (304, 128) polyphase matmul were MXU and lane
// artefacts and have no counterpart here.
#include "common.cuh"

namespace {

constexpr int kTaps = 49;
constexpr int kHalf = kTaps / 2;  // 24
constexpr int kTile = 256;        // output rows per block == threads

struct Taps {
  float v[kTaps];
};

// numpy 'reflect' index of stream position s in a stream of length L
__device__ __forceinline__ long long reflect_row(long long s, long long L) {
  if (L == 1) return 0;
  const long long period = 2 * (L - 1);
  long long m = s % period;
  if (m < 0) m += period;
  return m < L ? m : period - m;
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kTile) cascade_pad_kernel(
    const Tin* __restrict__ in, long long in_stride, int head_in, int L_in,
    Tout* __restrict__ out, long long out_stride, int head_out, int L_out,
    int n_out, Taps taps) {
  __shared__ float win[2 * kTile + 2 * kHalf];
  const Tin* x = in + blockIdx.y * in_stride + head_in;
  Tout* y = out + blockIdx.y * out_stride;
  const long long r0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long r = r0 + threadIdx.x;
  const long long k0 = r0 - head_out;
  if (k0 >= 0 && k0 + kTile <= L_out) {
    // interior tile (uniform across the block): rows map to consecutive
    // decimated samples k0 .. k0+255, reading x[2*k0-24 .. 2*k0+534]
    const long long s0 = 2 * k0 - kHalf;
    for (int i = threadIdx.x; i < 2 * kTile + 2 * kHalf; i += kTile) {
      const long long s = s0 + i;
      win[i] = (s >= 0 && s < L_in) ? akt_to_float(x[s]) : 0.f;
    }
    __syncthreads();
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < kTaps; ++j)
      acc = fmaf(taps.v[j], win[2 * threadIdx.x + j], acc);
    y[r] = akt_from_float<Tout>(acc);
    return;
  }
  if (r >= n_out) return;
  float acc = 0.f;
  if (r < static_cast<long long>(L_out) + 2 * head_out + 1) {
    // reflect rows and tiles straddling them: same sum, same order, so a
    // reflected row is bit-equal to the interior sample it mirrors
    const long long s0 = 2 * reflect_row(r - head_out, L_out) - kHalf;
    for (int j = 0; j < kTaps; ++j) {
      const long long s = s0 + j;
      acc = fmaf(taps.v[j], (s >= 0 && s < L_in) ? akt_to_float(x[s]) : 0.f,
                 acc);
    }
  }
  y[r] = akt_from_float<Tout>(acc);
}

template <typename Tin, typename Tout>
void launch(const void* in, long long in_stride, int head_in, int L_in,
            void* out, long long out_stride, int head_out, int L_out,
            int n_out, int batch, const Taps& taps, cudaStream_t stream) {
  const dim3 grid((n_out + kTile - 1) / kTile, batch);
  cascade_pad_kernel<Tin, Tout><<<grid, kTile, 0, stream>>>(
      static_cast<const Tin*>(in), in_stride, head_in, L_in,
      static_cast<Tout*>(out), out_stride, head_out, L_out, n_out, taps);
}

}  // namespace

extern "C" int akt_cascade_pad(const void* in, int in_dtype,
                               long long in_stride, int head_in, int L_in,
                               void* out, int out_dtype, long long out_stride,
                               int head_out, int L_out, int n_out, int batch,
                               const float* taps_host, void* stream) {
  if (n_out < L_out + 2 * head_out + 1 || batch < 1 || batch > 65535)
    return AKT_BAD_ARGS;
  Taps taps;
  for (int j = 0; j < kTaps; ++j) taps.v[j] = taps_host[j];
  auto s = static_cast<cudaStream_t>(stream);
  const bool f32_out = out_dtype == AKT_F32;
  if (out_dtype != AKT_F32 && out_dtype != AKT_BF16) return AKT_BAD_ARGS;
#define AKT_LAUNCH(TIN)                                                      \
  if (f32_out)                                                               \
    launch<TIN, float>(in, in_stride, head_in, L_in, out, out_stride,        \
                       head_out, L_out, n_out, batch, taps, s);              \
  else                                                                       \
    launch<TIN, __nv_bfloat16>(in, in_stride, head_in, L_in, out,            \
                               out_stride, head_out, L_out, n_out, batch,    \
                               taps, s);
  switch (in_dtype) {
    case AKT_F32: AKT_LAUNCH(float) break;
    case AKT_BF16: AKT_LAUNCH(__nv_bfloat16) break;
    case AKT_I16: AKT_LAUNCH(int16_t) break;
    default: return AKT_BAD_ARGS;
  }
#undef AKT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* akt_error_string(int code) {
  if (code == AKT_BAD_ARGS) return "unsupported arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
