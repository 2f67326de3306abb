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
//
// Stage probe: the same kernel, templated on a compile-time stage, stops
// early so the time of each stage can be told apart (replaces
// scripts/probe_cqt_kernel_stages.py::variant_kernel, the stage-truncated
// copies of the TPU response kernel). Every stage stages the whole window,
// chunk by chunk, as the production kernel does:
//   kLoad    windows read at the 16-aligned start (starts[t] / 16 * 16),
//            out[b][i][t] = x[aligned + i] for i < bpo (no bank, no GEMM);
//   kRealign windows read at the exact start, out[b][i][t] = x[start + i];
//   kGemm    bank and windows staged, the whole [cos|sin] GEMM at the
//            aligned start, out[b][i][t] = cos row i, raw;
//   kFull    the production kernel, bit for bit.
// On Hopper the realignment is an index offset, not a sublane rotate, so
// load and realign differ only in the address. The production launch is
// the kFull instantiation; `if constexpr` keeps its code unchanged.
#include "common.cuh"

namespace {

constexpr int kFrames = 64;     // frames per block (2 per thread column)
constexpr int kChunk = 32;      // n_fft samples staged per step
constexpr int kRowGroups = 8;   // threadIdx.y
constexpr int kMaxRows = 72;    // 2 * bpo, bpo <= 36
constexpr int kRowsPerThread = kMaxRows / kRowGroups;
constexpr int kThreads = 32 * kRowGroups;

// stage codes shared with ops/cqt_cuda.py STAGES
enum Stage { kLoad = 0, kRealign = 1, kGemm = 2, kFull = 3 };

template <typename Tin, int kStage>
__global__ void __launch_bounds__(kThreads) octave_response_kernel(
    const Tin* __restrict__ buf, long long buf_stride,
    const int* __restrict__ starts, int n_frames,
    const float* __restrict__ bank, const float* __restrict__ scales,
    int bpo, int n_fft, float* __restrict__ out, long long out_stride,
    int row0) {
  constexpr bool kAligned = kStage == kLoad || kStage == kGemm;
  constexpr bool kMatmul = kStage == kGemm || kStage == kFull;
  __shared__ float sb[kChunk][kMaxRows + 1];
  __shared__ float sw[kChunk][kFrames + 1];
  __shared__ float sres[kMaxRows][kFrames + 1];
  __shared__ int sst[kFrames];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * 32 + tx;
  const int rows = 2 * bpo;
  const int f0 = blockIdx.x * kFrames;
  const Tin* x = buf + blockIdx.y * buf_stride;
  if (tid < kFrames) {
    const int st = starts[min(f0 + tid, n_frames - 1)];
    sst[tid] = kAligned ? st / 16 * 16 : st;  // starts are >= 0
  }
  float acc[kRowsPerThread][2];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i][0] = acc[i][1] = 0.f;
  __syncthreads();
  for (int k0 = 0; k0 < n_fft; k0 += kChunk) {
    if constexpr (kMatmul) {
      for (int e = tid; e < kMaxRows * kChunk; e += kThreads) {
        const int row = e / kChunk, kk = e % kChunk;
        sb[kk][row] = (row < rows && k0 + kk < n_fft)
                          ? bank[row * n_fft + k0 + kk] : 0.f;
      }
    }
    for (int e = tid; e < kFrames * kChunk; e += kThreads) {
      const int f = e / kChunk, kk = e % kChunk;
      sw[kk][f] = (k0 + kk < n_fft) ? akt_to_float(x[sst[f] + k0 + kk]) : 0.f;
    }
    __syncthreads();
    if constexpr (kMatmul) {
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
    } else if (k0 < bpo) {
      // keep the window's first bpo samples (rows of sres)
      for (int e = tid; e < kFrames * kChunk; e += kThreads) {
        const int f = e / kChunk, kk = e % kChunk;
        if (k0 + kk < bpo) sres[k0 + kk][f] = sw[kk][f];
      }
    }
    __syncthreads();
  }
  if constexpr (kMatmul) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      sres[ty + kRowGroups * i][tx] = acc[i][0];
      sres[ty + kRowGroups * i][tx + 32] = acc[i][1];
    }
    __syncthreads();
  }
  float* o = out + blockIdx.y * out_stride;
  for (int e = tid; e < bpo * kFrames; e += kThreads) {
    const int bin = e / kFrames, f = e % kFrames;
    if (f0 + f < n_frames) {
      float v = sres[bin][f];
      if constexpr (kStage == kFull) {
        const float s = sres[bin + bpo][f];
        v = log1pf(sqrtf(v * v + s * s) * scales[bin]);
      }
      o[static_cast<long long>(row0 + bin) * n_frames + f0 + f] = v;
    }
  }
}

template <typename Tin, int kStage>
void launch(const void* buf, long long buf_stride, const int* starts,
            int n_frames, const float* bank, const float* scales, int bpo,
            int n_fft, float* out, long long out_stride, int row0, int batch,
            cudaStream_t stream) {
  const dim3 grid((n_frames + kFrames - 1) / kFrames, batch);
  const dim3 block(32, kRowGroups);
  octave_response_kernel<Tin, kStage><<<grid, block, 0, stream>>>(
      static_cast<const Tin*>(buf), buf_stride, starts, n_frames, bank,
      scales, bpo, n_fft, out, out_stride, row0);
}

template <int kStage>
int launch_dtype(const void* buf, int in_dtype, long long buf_stride,
                 const int* starts, int n_frames, const float* bank,
                 const float* scales, int bpo, int n_fft, float* out,
                 long long out_stride, int row0, int batch,
                 cudaStream_t stream) {
  switch (in_dtype) {
    case AKT_F32:
      launch<float, kStage>(buf, buf_stride, starts, n_frames, bank, scales,
                            bpo, n_fft, out, out_stride, row0, batch, stream);
      break;
    case AKT_BF16:
      launch<__nv_bfloat16, kStage>(buf, buf_stride, starts, n_frames, bank,
                                    scales, bpo, n_fft, out, out_stride, row0,
                                    batch, stream);
      break;
    case AKT_I16:
      launch<int16_t, kStage>(buf, buf_stride, starts, n_frames, bank, scales,
                              bpo, n_fft, out, out_stride, row0, batch,
                              stream);
      break;
    default:
      return AKT_BAD_ARGS;
  }
  return static_cast<int>(cudaGetLastError());
}

bool bad_geometry(int bpo, int n_frames, int batch) {
  return bpo < 1 || 2 * bpo > kMaxRows || n_frames < 1 || batch < 1 ||
         batch > 65535;
}

}  // namespace

extern "C" int akt_octave_response(const void* buf, int in_dtype,
                                   long long buf_stride, const int* starts,
                                   int n_frames, const float* bank,
                                   const float* scales, int bpo, int n_fft,
                                   float* out, long long out_stride, int row0,
                                   int batch, void* stream) {
  if (bad_geometry(bpo, n_frames, batch)) return AKT_BAD_ARGS;
  return launch_dtype<kFull>(buf, in_dtype, buf_stride, starts, n_frames,
                             bank, scales, bpo, n_fft, out, out_stride, row0,
                             batch, static_cast<cudaStream_t>(stream));
}

// One stage of the probe into a (batch, bpo, n_frames) float32 tensor.
extern "C" int akt_octave_response_stage(const void* buf, int in_dtype,
                                         long long buf_stride,
                                         const int* starts, int n_frames,
                                         const float* bank,
                                         const float* scales, int bpo,
                                         int n_fft, float* out, int stage,
                                         int batch, void* stream) {
  if (bad_geometry(bpo, n_frames, batch)) return AKT_BAD_ARGS;
  const long long out_stride = static_cast<long long>(bpo) * n_frames;
  auto s = static_cast<cudaStream_t>(stream);
#define AKT_STAGE(S)                                                        \
  return launch_dtype<S>(buf, in_dtype, buf_stride, starts, n_frames, bank, \
                         scales, bpo, n_fft, out, out_stride, 0, batch, s);
  switch (stage) {
    case kLoad: AKT_STAGE(kLoad)
    case kRealign: AKT_STAGE(kRealign)
    case kGemm: AKT_STAGE(kGemm)
    case kFull: AKT_STAGE(kFull)
    default: return AKT_BAD_ARGS;
  }
#undef AKT_STAGE
}
