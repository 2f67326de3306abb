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
// Accumulates in float32, taps in order j = 0..48 from 0; int16 PCM
// (octave 0 -> 1) arrives with 1/32768 already folded into the taps;
// output is float32 or bfloat16. The output rows may be a slice of a
// wider buffer (out_stride): cqt_cuda writes every octave into one arena.
//
// What bounds it on the H100: its bytes (each stream read once, the next
// written once), with 49 FMAs per output close behind (4.1 GFLOP f32 at
// the serving geometry against 252 MB; PERF.md). Design, register-blocked:
// a block of 128 threads owns 2048 consecutive output rows of one clip
// (clip = blockIdx.y). It stages the 4144 input samples they read in
// shared memory once, with 16-byte global loads (coalesced) and 16-byte
// shared stores, converted to float32 and skewed by 16 bytes every 128
// bytes so that the threads' 16-byte reads below meet no bank conflict.
// Each thread then computes 16 consecutive outputs from a register window
// of 80 samples (20 shared loads of 16 bytes, 5 samples per 49-tap output
// instead of 49 scalar stride-2 loads with a 2-way conflict) and writes
// them with 16-byte stores. In the few tiles that reach into the reflect
// rows or the zero tail, the whole block then computes those rows, one
// per thread, from the staged samples where the mirrored row's inputs
// lie in the tile's window (else from device memory), summing in the
// same order, so a reflected row is bit-equal to the interior sample it
// mirrors. The TPU's time-major (L, B) layout and
// (304, 128) polyphase matmul were MXU and lane artefacts and have no
// counterpart here.
#include "common.cuh"

namespace {

constexpr int kTaps = 49;
constexpr int kHalf = kTaps / 2;              // 24
constexpr int kThreads = 128;
constexpr int kPer = 16;                      // outputs per thread
constexpr int kTile = kThreads * kPer;        // output rows per block
constexpr int kWin = 2 * kTile + 2 * kHalf;   // staged input samples
constexpr int kReg = 2 * kPer + 2 * kHalf;    // register window (80)

struct Taps {
  float v[kTaps];
};

// shared-memory index of staged sample i: 4 floats of padding after every
// 32, so the 16-byte reads of 8 threads 128 bytes apart hit distinct banks
__device__ __forceinline__ int skew(int i) { return i + ((i >> 5) << 2); }
constexpr int kWinSkewed = kWin + ((kWin >> 5) << 2) + 4;

// numpy 'reflect' index of stream position s in a stream of length L
__device__ __forceinline__ long long reflect_row(long long s, long long L) {
  if (L == 1) return 0;
  const long long period = 2 * (L - 1);
  long long m = s % period;
  if (m < 0) m += period;
  return m < L ? m : period - m;
}

// one 16-byte vector of the stream as floats
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* v);
template <>
__device__ __forceinline__ void load_vec<float>(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16>(const __nv_bfloat16* p,
                                                        float* v) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}
template <>
__device__ __forceinline__ void load_vec<int16_t>(const int16_t* p, float* v) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = static_cast<float>(static_cast<int16_t>(w[i] & 0xFFFFu));
    v[2 * i + 1] = static_cast<float>(static_cast<int16_t>(w[i] >> 16));
  }
}

// kPer consecutive outputs with 16-byte stores
__device__ __forceinline__ void store_row(float* y, const float* a) {
#pragma unroll
  for (int i = 0; i < kPer / 4; ++i)
    reinterpret_cast<float4*>(y)[i] =
        make_float4(a[4 * i], a[4 * i + 1], a[4 * i + 2], a[4 * i + 3]);
}
__device__ __forceinline__ void store_row(__nv_bfloat16* y, const float* a) {
  uint32_t w[kPer / 2];
#pragma unroll
  for (int i = 0; i < kPer / 2; ++i) {
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(a[2 * i]));
    const uint32_t hi =
        __bfloat16_as_ushort(__float2bfloat16_rn(a[2 * i + 1]));
    w[i] = lo | (hi << 16);
  }
#pragma unroll
  for (int i = 0; i < kPer / 8; ++i)
    reinterpret_cast<uint4*>(y)[i] =
        make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads) cascade_pad_kernel(
    const Tin* __restrict__ in, long long in_stride, int head_in, int L_in,
    Tout* __restrict__ out, long long out_stride, int head_out, int L_out,
    int n_out, Taps taps) {
  constexpr int V = 16 / sizeof(Tin);  // samples per 16-byte vector
  __shared__ __align__(16) float win[kWinSkewed];
  const Tin* row = in + blockIdx.y * in_stride;
  const Tin* x = row + head_in;
  Tout* y = out + blockIdx.y * out_stride;
  const int r0 = blockIdx.x * kTile;
  // staged sample i is x[s0 + i]; output row r0 + m reads x[s0 + 2m + j]
  const int s0 = 2 * (r0 - head_out) - kHalf;
  // head_in and head_out are multiples of 8 (the launcher refuses others),
  // so x + s0 starts on a 16-byte boundary: 16-byte loads and stores
  for (int q = threadIdx.x; q < kWin / V; q += kThreads) {
    const int s = s0 + q * V;
    float v[V];
    if (s >= 0 && s + V <= L_in) {
      load_vec<Tin>(x + s, v);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        v[e] = (s + e >= 0 && s + e < L_in) ? akt_to_float(x[s + e]) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; e += 4)
      *reinterpret_cast<float4*>(&win[skew(q * V + e)]) =
          make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
  }
  __syncthreads();

  const int t = threadIdx.x;
  float xr[kReg];
#pragma unroll
  for (int v = 0; v < kReg / 4; ++v) {
    const float4 q =
        *reinterpret_cast<const float4*>(&win[skew(2 * kPer * t + 4 * v)]);
    xr[4 * v] = q.x, xr[4 * v + 1] = q.y, xr[4 * v + 2] = q.z,
            xr[4 * v + 3] = q.w;
  }
  float acc[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) acc[m] = 0.f;
#pragma unroll
  for (int j = 0; j < kTaps; ++j) {
    const float tj = taps.v[j];
#pragma unroll
    for (int m = 0; m < kPer; ++m) acc[m] = fmaf(tj, xr[2 * m + j], acc[m]);
  }

  const int r = r0 + kPer * t;   // this thread's first row
  const int k = r - head_out;    // its decimated sample
  if (k >= 0 && k + kPer <= L_out) {   // every row interior: vector stores
    store_row(y + r, acc);
  } else {
    for (int m = 0; m < kPer; ++m)
      if (k + m >= 0 && k + m < L_out) y[r + m] = akt_from_float<Tout>(acc[m]);
  }
  // The tile's other rows (reflect rows and the zero tail), one row per
  // thread of the block: a reflect row is the interior row it mirrors,
  // summed again from device memory in the same order, so bit-equal.
  const int k0 = r0 - head_out;
  if (k0 >= 0 && k0 + kTile <= L_out) return;   // uniform over the block
  const int n_pad = L_out + 2 * head_out + 1;
  const int r_end = min(r0 + kTile, n_out);
  for (int rm = r0 + t; rm < r_end; rm += kThreads) {
    const int km = rm - head_out;
    if (km >= 0 && km < L_out) continue;   // written above
    float v = 0.f;
    if (rm < n_pad) {
      const int sm = 2 * static_cast<int>(reflect_row(km, L_out)) - kHalf;
      const int i0 = sm - s0;  // the mirrored row's inputs, when staged
      if (i0 >= 0 && i0 + kTaps <= kWin) {
#pragma unroll
        for (int j = 0; j < kTaps; ++j)
          v = fmaf(taps.v[j], win[skew(i0 + j)], v);
      } else {
        float xs[kTaps];
#pragma unroll
        for (int j = 0; j < kTaps; ++j) {
          const int s = sm + j;
          xs[j] = (s >= 0 && s < L_in) ? akt_to_float(x[s]) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kTaps; ++j) v = fmaf(taps.v[j], xs[j], v);
      }
    }
    y[rm] = akt_from_float<Tout>(v);
  }
}

template <typename Tin, typename Tout>
void launch(const void* in, long long in_stride, int head_in, int L_in,
            void* out, long long out_stride, int head_out, int L_out,
            int n_out, int batch, const Taps& taps, cudaStream_t stream) {
  const dim3 grid((n_out + kTile - 1) / kTile, batch);
  cascade_pad_kernel<Tin, Tout><<<grid, kThreads, 0, stream>>>(
      static_cast<const Tin*>(in), in_stride, head_in, L_in,
      static_cast<Tout*>(out), out_stride, head_out, L_out, n_out, taps);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// in / out rows start 16-byte aligned and their strides keep them so, and
// head_in / head_out are multiples of 8 (the 16-byte loads and stores
// above); n_out is a multiple of 8 (a row of kPer outputs ends inside it
// when it starts inside the interior).
extern "C" int akt_cascade_pad(const void* in, int in_dtype,
                               long long in_stride, int head_in, int L_in,
                               void* out, int out_dtype, long long out_stride,
                               int head_out, int L_out, int n_out, int batch,
                               const float* taps_host, void* stream) {
  if (n_out < L_out + 2 * head_out + 1 || n_out % 8 != 0 || batch < 1 ||
      batch > 65535 || !aligned16(in) || !aligned16(out) ||
      in_stride % 8 != 0 || out_stride % 8 != 0 || head_in % 8 != 0 ||
      head_out % 8 != 0 || head_in < 0 || head_out < 0)
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
