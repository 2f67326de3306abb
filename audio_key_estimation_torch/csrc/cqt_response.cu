// Kernel B — CQT octave response: frame gather x [cos|sin] bank GEMM ->
// magnitude -> scale -> log1p, written straight into the (B, n_bins, T)
// feature tensor.
//
// Replaces audio_key_estimation_tpu/ops/cqt_pallas.py::_octave_response_frames
// (shallow octaves, one DMA per window) AND ::_octave_response_span (deep
// octaves, one DMA per K overlapping windows). On Hopper the windows are
// read by index, so one kernel covers both: overlapping deep-octave windows
// simply hit L1/L2 instead of needing a span DMA.
//
// Computes, for clip b and frame t of one octave,
//   r[row] = sum_k bank[row][k] * x[starts[t] + k]     (row < 2*bpo, f32)
//   out[b][row0 + i][t] = log1p(sqrt(r[i]^2 + r[bpo+i]^2) * scales[i])
// where x is the octave's reflect-padded stream (int16 PCM, float32 or
// bfloat16) and scales already hold sqrt(kernel length) * 2^(o/2) (and
// 1/32768 for int16 input).
//
// What bounds it on the H100: float32 FMA rate (73.7 kFLOP per frame;
// the bank must stay float32 — bf16 or TF32 operands miss the 1e-4 bar),
// then shared-memory bandwidth. Design: a block owns 64 frames of one clip
// and loops over n_fft in chunks of 32 samples, staging the bank chunk
// ([k][row], 72 rows) and the 64 window chunks ([k][frame]) in shared
// memory with padded strides (conflict-free). Each of the 256 threads keeps
// a 9-row x 2-frame register tile, so every k step is 11 shared loads
// (bank reads are warp broadcasts) for 18 FMAs. The bank (144 KB) is
// streamed chunk by chunk from L2 rather than held whole. The GEMM is
// computed here, not by cuBLAS. The TPU's 128-lane batch padding, lane
// chunking and XLA fallback have no counterpart: any B runs. As written,
// one launch per octave at 16 clips x 601 frames is 160 blocks — one
// partial wave on 132 SMs — so latency, not the FMA rate, holds it
// under 7 TFLOP/s on an H100 at 700 W (PERF.md); one launch over several
// octaves is the next step.
#include "common.cuh"

namespace {

constexpr int kFrames = 64;     // frames per block (2 per thread column)
constexpr int kChunk = 32;      // n_fft samples staged per step
constexpr int kRowGroups = 8;   // threadIdx.y
constexpr int kMaxRows = 72;    // 2 * bpo, bpo <= 36
constexpr int kRowsPerThread = kMaxRows / kRowGroups;
constexpr int kThreads = 32 * kRowGroups;

template <typename Tin>
__global__ void __launch_bounds__(kThreads) octave_response_kernel(
    const Tin* __restrict__ buf, long long buf_stride,
    const int* __restrict__ starts, int n_frames,
    const float* __restrict__ bank, const float* __restrict__ scales,
    int bpo, int n_fft, float* __restrict__ out, long long out_stride,
    int row0) {
  __shared__ float sb[kChunk][kMaxRows + 1];
  __shared__ float sw[kChunk][kFrames + 1];
  __shared__ float sres[kMaxRows][kFrames + 1];
  __shared__ int sst[kFrames];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * 32 + tx;
  const int rows = 2 * bpo;
  const int f0 = blockIdx.x * kFrames;
  const Tin* x = buf + blockIdx.y * buf_stride;
  if (tid < kFrames) sst[tid] = starts[min(f0 + tid, n_frames - 1)];
  float acc[kRowsPerThread][2];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i][0] = acc[i][1] = 0.f;
  __syncthreads();
  for (int k0 = 0; k0 < n_fft; k0 += kChunk) {
    for (int e = tid; e < kMaxRows * kChunk; e += kThreads) {
      const int row = e / kChunk, kk = e % kChunk;
      sb[kk][row] = (row < rows && k0 + kk < n_fft)
                        ? bank[row * n_fft + k0 + kk] : 0.f;
    }
    for (int e = tid; e < kFrames * kChunk; e += kThreads) {
      const int f = e / kChunk, kk = e % kChunk;
      sw[kk][f] = (k0 + kk < n_fft) ? akt_to_float(x[sst[f] + k0 + kk]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kChunk; ++kk) {
      const float w0 = sw[kk][tx], w1 = sw[kk][tx + 32];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float bv = sb[kk][ty + kRowGroups * i];
        acc[i][0] = fmaf(bv, w0, acc[i][0]);
        acc[i][1] = fmaf(bv, w1, acc[i][1]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    sres[ty + kRowGroups * i][tx] = acc[i][0];
    sres[ty + kRowGroups * i][tx + 32] = acc[i][1];
  }
  __syncthreads();
  float* o = out + blockIdx.y * out_stride;
  for (int e = tid; e < bpo * kFrames; e += kThreads) {
    const int bin = e / kFrames, f = e % kFrames;
    if (f0 + f < n_frames) {
      const float c = sres[bin][f], s = sres[bin + bpo][f];
      o[static_cast<long long>(row0 + bin) * n_frames + f0 + f] =
          log1pf(sqrtf(c * c + s * s) * scales[bin]);
    }
  }
}

template <typename Tin>
void launch(const void* buf, long long buf_stride, const int* starts,
            int n_frames, const float* bank, const float* scales, int bpo,
            int n_fft, float* out, long long out_stride, int row0, int batch,
            cudaStream_t stream) {
  const dim3 grid((n_frames + kFrames - 1) / kFrames, batch);
  const dim3 block(32, kRowGroups);
  octave_response_kernel<Tin><<<grid, block, 0, stream>>>(
      static_cast<const Tin*>(buf), buf_stride, starts, n_frames, bank,
      scales, bpo, n_fft, out, out_stride, row0);
}

}  // namespace

extern "C" int akt_octave_response(const void* buf, int in_dtype,
                                   long long buf_stride, const int* starts,
                                   int n_frames, const float* bank,
                                   const float* scales, int bpo, int n_fft,
                                   float* out, long long out_stride, int row0,
                                   int batch, void* stream) {
  if (bpo < 1 || 2 * bpo > kMaxRows || n_frames < 1 || batch < 1 ||
      batch > 65535)
    return AKT_BAD_ARGS;
  auto s = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case AKT_F32:
      launch<float>(buf, buf_stride, starts, n_frames, bank, scales, bpo,
                    n_fft, out, out_stride, row0, batch, s);
      break;
    case AKT_BF16:
      launch<__nv_bfloat16>(buf, buf_stride, starts, n_frames, bank, scales,
                            bpo, n_fft, out, out_stride, row0, batch, s);
      break;
    case AKT_I16:
      launch<int16_t>(buf, buf_stride, starts, n_frames, bank, scales, bpo,
                      n_fft, out, out_stride, row0, batch, s);
      break;
    default:
      return AKT_BAD_ARGS;
  }
  return static_cast<int>(cudaGetLastError());
}
