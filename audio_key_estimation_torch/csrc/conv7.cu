// Kernel C — one eval-mode Pitch2Pitch layer: 7x7 convolution, circular on
// pitch (H) and time (T), BatchNorm folded into weights and bias,
// leaky-ReLU 0.01. bf16 in and out, float32 accumulation.
//
// Replaces audio_key_estimation_tpu/ops/convstack_pallas.py::_conv7_layer.
//
// Layout: channels-last (B, H, T, 8) bf16 with the input channels zero-
// padded to 8, so one position's channels are one 16-byte load. Weights
// arrive with BatchNorm folded in float32 outside the kernel and then cast
// to bf16 (as the JAX package does), packed as (50 taps, 8 co, 8 ci) with
// tap 49 and ci >= ci_true zero.
//
// Implicit GEMM on the tensor cores with mma.sync m16n8k16 (bf16 -> f32):
// M = 16 consecutive time positions of one (clip, pitch row), N = the 8
// output channels, K = (tap pair, 8 ci) — 25 k-steps cover the 49 taps.
// The A fragment's four 32-bit registers are exactly (position g or g+8,
// tap 2s or 2s+1, channel pair q) of the staged input; the B fragments for
// all 25 k-steps (50 registers) are loaded once per thread.
//
// What bounds it on the H100: device-memory bytes (16 B read + 16 B
// written per position, 49x reuse of each input through shared memory)
// and, at 8 output channels, the shared-memory load rate of the A
// fragments rather than tensor-core FLOPs. Design: a block owns a
// 4 (pitch) x 64 (time) output tile of one clip and stages its
// 10 x 70-position halo in shared memory once; the circular wrap on both
// axes is index arithmetic on the halo load, so no padded copy of the
// activations is ever written (the TPU version materialized three). The
// TPU's 2.04x block-Toeplitz weight packing was an MXU-filling artefact
// and is not used.
#include "common.cuh"

namespace {

constexpr int kTileH = 4;                 // pitch rows per block (one/warp)
constexpr int kTileT = 64;                // time positions per block
constexpr int kHaloH = kTileH + 6;
constexpr int kHaloT = kTileT + 6;
constexpr int kKSteps = 25;               // ceil(49 / 2) tap pairs
constexpr int kThreads = 32 * kTileH;

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads) conv7_kernel(
    const uint4* __restrict__ x, const uint32_t* __restrict__ w,
    const float* __restrict__ bias,
    uint32_t* __restrict__ y, int H, int T) {
  // halo of the tile: one uint4 (8 bf16 channels) per position
  __shared__ uint4 halo[kHaloH * kHaloT];
  const int b = blockIdx.z;
  const int h0 = blockIdx.y * kTileH;
  const int t0 = blockIdx.x * kTileT;
  const long long plane = static_cast<long long>(H) * T;
  const uint4* xb = x + b * plane;
  for (int i = threadIdx.x; i < kHaloH * kHaloT; i += kThreads) {
    const int hh = wrap(h0 - 3 + i / kHaloT, H);
    const int tt = wrap(t0 - 3 + i % kHaloT, T);
    halo[i] = xb[static_cast<long long>(hh) * T + tt];
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;      // pitch row within the tile
  const int g = lane >> 2, q = lane & 3;  // mma fragment coordinates
  uint32_t bw[kKSteps][2];
#pragma unroll
  for (int s = 0; s < kKSteps; ++s) {
    bw[s][0] = w[(2 * s) * 32 + g * 4 + q];
    bw[s][1] = w[(2 * s + 1) * 32 + g * 4 + q];
  }
  __syncthreads();
  const uint32_t* hs = reinterpret_cast<const uint32_t*>(halo);
  const int h = h0 + warp;
  const float b0 = bias[2 * q], b1 = bias[2 * q + 1];
#pragma unroll 1
  for (int mt = 0; mt < kTileT / 16; ++mt) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const int tl = mt * 16 + g;  // local time of fragment rows g / g+8
#pragma unroll
    for (int s = 0; s < kKSteps; ++s) {
      // tap 49 does not exist: its weights are zero, point it at tap 0
      const int tap0 = 2 * s, tap1 = (2 * s + 1 < 49) ? 2 * s + 1 : 0;
      const int p0 = (warp + tap0 / 7) * kHaloT + tl + tap0 % 7;
      const int p1 = (warp + tap1 / 7) * kHaloT + tl + tap1 % 7;
      uint32_t a[4];
      a[0] = hs[p0 * 4 + q];
      a[1] = hs[(p0 + 8) * 4 + q];
      a[2] = hs[p1 * 4 + q];
      a[3] = hs[(p1 + 8) * 4 + q];
      mma_bf16_16816(acc, a, bw[s][0], bw[s][1]);
    }
    if (h < H) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = t0 + tl + 8 * half;
        if (t < T) {
          float v0 = acc[2 * half] + b0, v1 = acc[2 * half + 1] + b1;
          v0 = v0 >= 0.f ? v0 : 0.01f * v0;
          v1 = v1 >= 0.f ? v1 : 0.01f * v1;
          __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
          y[((b * plane) + static_cast<long long>(h) * T + t) * 4 + q] =
              *reinterpret_cast<uint32_t*>(&o);
        }
      }
    }
  }
}

}  // namespace

extern "C" int akt_conv7(const void* x, const void* w_packed,
                         const float* bias, void* y, int batch, int H, int T,
                         void* stream) {
  if (batch < 1 || batch > 65535 || H < 3 || T < 3 ||
      (H + kTileH - 1) / kTileH > 65535)
    return AKT_BAD_ARGS;
  const dim3 grid((T + kTileT - 1) / kTileT, (H + kTileH - 1) / kTileH,
                  batch);
  conv7_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<const uint32_t*>(w_packed),
      bias, static_cast<uint32_t*>(y), H, T);
  return static_cast<int>(cudaGetLastError());
}
