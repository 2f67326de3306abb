// Kernel B — CQT octave response: frame gather x [cos|sin] bank GEMM ->
// magnitude -> scale -> log1p, written straight into the (B, n_bins, T)
// feature tensor, for every octave in one launch.
//
// Replaces audio_key_estimation_tpu/ops/cqt_pallas.py::_octave_response_frames
// (shallow octaves, one DMA per window) AND ::_octave_response_span (deep
// octaves, one DMA per K overlapping windows).
//
// Computes, for clip b, octave o and frame t,
//   r[row] = sum_k bank[row][k] * x_o[starts[o][t] + k]  (row < 2*bpo, f32)
//   out[b][row0(o) + i][t] = log1p(sqrt(r[i]^2 + r[bpo+i]^2) * scales[o][i])
// with row0(o) = (n_oct - 1 - o) * bpo, where x_o is octave o's
// reflect-padded stream: octave 0 its own buffer (int16 PCM or float32),
// octaves >= 1 slices of one arena (float32 or bfloat16) at per-octave
// offsets. scales hold sqrt(kernel length) * 2^(o/2) (and 1/32768 for
// int16 input).
//
// What bounds it on the H100: the TF32 products of its float32-accurate
// GEMM (73.7 kFLOP per frame and product; 2 products on bf16 streams, 3
// on int16 or float32: 12.05 GFLOP at the serving geometry; PERF.md).
// Design:
//  * one launch, grid (frame tiles, clips, octaves): 640 blocks of 128
//    frames at 16 clips x 601 frames x 8 octaves, instead of eight
//    launches of one partial wave each;
//  * the GEMM on the tensor cores at float32 accuracy, 3xTF32:
//    x = x_hi + x_lo and bank = b_hi + b_lo (TF32 parts), summing
//    x_lo*b_hi + x_hi*b_lo + x_hi*b_hi in float32 with
//    mma.sync.m16n8k8.tf32 (bf16 or TF32 operands alone miss the 1e-4
//    bar). A bf16 stream is exact in TF32, so x_lo = 0 and its octaves
//    take two products. The bank's split is made once on the host
//    (cqt_cuda.make_bank), laid out in the mma's fragment order so
//    that a lane reads its B fragments with conflict-free 8-byte loads.
//    M = frames (each of 4 warps owns 32 frames, 2 m16 tiles), N = 72
//    bank rows (9 n8 tiles), K = n_fft in chunks of 32;
//  * window staging by cp.async, 16 bytes a copy, into a double-buffered
//    shared ring: chunk c + 1 of the bank and of every window is in
//    flight while chunk c is multiplied. A window's chunk is copied from
//    the 16-byte boundary below it and read at its offset (the TPU's
//    sublane realignment is an index here);
//  * where a tile's windows overlap (hop < n_fft, deep octaves) and the
//    samples they cover fit the ring, the block copies that span once and
//    reads every window from it at its offset, as _octave_response_span
//    does on the TPU. The choice is per block, from the tile's starts;
//    both read the same values, so the result does not depend on it;
//  * the epilogue (magnitude, scale, log1p) through shared memory, stores
//    coalesced along frames. The GEMM is computed here, not by cuBLAS.
// The TPU's 128-lane batch padding, lane chunking and XLA fallback have
// no counterpart: any B runs.
//
// Stage probe: the same kernel, templated on a compile-time stage, stops
// early so the time of each stage can be told apart (replaces
// scripts/probe_cqt_kernel_stages.py::variant_kernel, the stage-truncated
// copies of the TPU response kernel). One octave per launch; every stage
// stages the windows chunk by chunk (or as a span) as the production
// kernel does:
//   kLoad    windows read at the 16-aligned start (starts[t] / 16 * 16),
//            out[b][i][t] = x[aligned + i] for i < bpo (no bank, no GEMM);
//   kRealign windows read at the exact start, out[b][i][t] = x[start + i];
//   kGemm    bank and windows staged, the whole [cos|sin] GEMM at the
//            aligned start, out[b][i][t] = cos row i, raw;
//   kFull    the production kernel's octave body, bit for bit.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kFrames = 128;        // frames per block
constexpr int kWarps = 4;           // each owns 32 frames
constexpr int kThreads = 32 * kWarps;
constexpr int kMT = 2;              // m16 tiles per warp
constexpr int kNT = 9;              // n8 tiles
constexpr int kMaxRows = 8 * kNT;   // 72 = 2 * bpo, bpo <= 36
constexpr int kChunk = 32;          // window samples per pipeline stage
constexpr int kSteps = kChunk / 8;  // k8 steps per chunk
constexpr int kMaxOctaves = 16;
constexpr int kFrag = 2 * kNT;                    // bank floats per lane per k8 step
constexpr int kBankChunk = kSteps * 32 * kFrag;   // floats per part per chunk
constexpr int kBankBytes = 2 * 2 * kBankChunk * 4;  // 2 stages x (hi, lo)
constexpr int kResStride = kFrames + 1;
constexpr int kResBytes = kMaxRows * kResStride * 4;

// stage codes shared with ops/cqt_cuda.py STAGES
enum Stage { kLoad = 0, kRealign = 1, kGemm = 2, kFull = 3 };

// A window chunk's row in the ring: the chunk plus the vector it may start
// inside of, in 16-byte vectors.
template <typename T>
__host__ __device__ constexpr int row_bytes() {
  return (kChunk / (16 / static_cast<int>(sizeof(T))) + 1) * 16;
}
template <typename T>
__host__ __device__ constexpr int ring_bytes() {
  return 2 * kFrames * row_bytes<T>();
}
template <typename T0, typename TS>
__host__ __device__ constexpr int smem_bytes() {
  return kBankBytes + (ring_bytes<T0>() > ring_bytes<TS>() ? ring_bytes<T0>()
                                                           : ring_bytes<TS>());
}
static_assert(kResBytes <= kBankBytes + ring_bytes<int16_t>(),
              "the epilogue's tile reuses the ring");

// per-octave layout of the streams
struct Octaves {
  long long offset[kMaxOctaves];  // octave o >= 1: first column in the arena
  int length[kMaxOctaves];        // columns of the octave's padded stream
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One octave of one clip for this block's frame tile. x: the clip's padded
// stream of the octave (`length` columns); o: its first output row.
template <typename T, int kStage>
__device__ __forceinline__ void octave_body(
    const T* __restrict__ x, int length, const int* __restrict__ starts,
    int n_frames, const float* __restrict__ bank_hi,
    const float* __restrict__ bank_lo, const float* __restrict__ scales,
    int bpo, int n_fft, float* __restrict__ o, unsigned char* smem, int* sst,
    int* soff) {
  constexpr bool kAligned = kStage == kLoad || kStage == kGemm;
  constexpr bool kMatmul = kStage == kGemm || kStage == kFull;
  constexpr bool kExactTf32 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int V = 16 / sizeof(T);                 // samples per vector
  constexpr int kRowElems = row_bytes<T>() / sizeof(T);
  constexpr int kVecs = row_bytes<T>() / 16;
  constexpr int kSpanCap = 2 * kFrames * kRowElems;  // samples the ring holds
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int f0 = blockIdx.x * kFrames;
  float* sbank = reinterpret_cast<float*>(smem);
  T* sring = reinterpret_cast<T*>(smem + kBankBytes);

  if (tid < kFrames) {
    const int st = starts[min(f0 + tid, n_frames - 1)];
    sst[tid] = kAligned ? st / 16 * 16 : st;  // starts are >= 0
  }
  __syncthreads();
  // span: the samples every window of the tile covers, from the vector
  // boundary below the first start (starts ascend)
  const int span0 = sst[0] / V * V;
  const int span_end =
      (sst[min(kFrames, n_frames - f0) - 1] + n_fft + V - 1) / V * V;
  const bool span = span_end - span0 <= kSpanCap;  // uniform over the block
  if (tid < kFrames) soff[tid] = span ? sst[tid] - span0 : sst[tid] % V;

  auto stage = [&](int c, int buf) {
    if constexpr (kMatmul) {
      const float* gh = bank_hi + static_cast<long long>(c) * kBankChunk;
      const float* gl = bank_lo + static_cast<long long>(c) * kBankChunk;
      float* dh = sbank + buf * 2 * kBankChunk;
      for (int e = tid; e < kBankChunk / 4; e += kThreads) {
        cp_async16(dh + 4 * e, gh + 4 * e);
        cp_async16(dh + kBankChunk + 4 * e, gl + 4 * e);
      }
    }
    if (!span) {
      const int k0 = c * kChunk;
      T* dst = sring + buf * kFrames * kRowElems;
      for (int e = tid; e < kFrames * kVecs; e += kThreads) {
        const int f = e / kVecs, q = e % kVecs;
        const int a = (sst[f] + k0) / V * V + q * V;  // column of the vector
        T* d = dst + f * kRowElems + q * V;
        if (a + V <= length)
          cp_async16(d, x + a);
        else  // never read: every window lies inside its stream
          *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
      }
    }
    cp_async_commit();
  };

  if (span) {  // copied once, in the first chunk's group
    for (int e = tid; e < (span_end - span0) / V; e += kThreads) {
      const int a = span0 + e * V;
      if (a + V <= length)
        cp_async16(sring + e * V, x + a);
      else
        *reinterpret_cast<uint4*>(sring + e * V) = make_uint4(0, 0, 0, 0);
    }
  }

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;

  const int n_chunks = n_fft / kChunk;
  stage(0, 0);
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < n_chunks) {
      stage(c + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // sample kk of chunk c of frame f: wbase[f * fstride + soff[f] + kk]
    const T* wbase =
        span ? sring + c * kChunk : sring + buf * kFrames * kRowElems;
    const int fstride = span ? 0 : kRowElems;
    if constexpr (kMatmul) {
      const T* pa[kMT][2];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int f = warp * 32 + mt * 16 + (lane >> 2) + 8 * h;
          pa[mt][h] = wbase + f * fstride + soff[f];
        }
      const float* bh = sbank + buf * 2 * kBankChunk;
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const int kk = s * 8 + (lane & 3);
        uint32_t ahi[kMT][4], alo[kMT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          const float v[4] = {akt_to_float(pa[mt][0][kk]),
                              akt_to_float(pa[mt][1][kk]),
                              akt_to_float(pa[mt][0][kk + 4]),
                              akt_to_float(pa[mt][1][kk + 4])};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if constexpr (kExactTf32) {
              ahi[mt][i] = __float_as_uint(v[i]);
            } else {
              ahi[mt][i] = to_tf32(v[i]);
              alo[mt][i] = to_tf32(v[i] - __uint_as_float(ahi[mt][i]));
            }
          }
        }
        const float2* fh =
            reinterpret_cast<const float2*>(bh + (s * 32 + lane) * kFrag);
        const float2* fl = reinterpret_cast<const float2*>(
            bh + kBankChunk + (s * 32 + lane) * kFrag);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const float2 hi = fh[j], lo = fl[j];
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            if constexpr (!kExactTf32)
              mma_tf32(acc[mt][j], alo[mt], __float_as_uint(hi.x),
                       __float_as_uint(hi.y));
            mma_tf32(acc[mt][j], ahi[mt], __float_as_uint(lo.x),
                     __float_as_uint(lo.y));
            mma_tf32(acc[mt][j], ahi[mt], __float_as_uint(hi.x),
                     __float_as_uint(hi.y));
          }
        }
      }
    } else if (c * kChunk < bpo) {
      // load / realign: the window's first bpo samples, raw
      for (int e = tid; e < kChunk * kFrames; e += kThreads) {
        const int kk = e / kFrames, f = e % kFrames;
        const int bin = c * kChunk + kk;
        if (bin < bpo && f0 + f < n_frames)
          o[static_cast<long long>(bin) * n_frames + f0 + f] =
              akt_to_float(wbase[f * fstride + soff[f] + kk]);
      }
    }
    __syncthreads();
  }

  if constexpr (kMatmul) {
    float* sres = reinterpret_cast<float*>(smem);  // the ring is done
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int f = warp * 32 + mt * 16 + (lane >> 2);
        const int n = j * 8 + 2 * (lane & 3);
        sres[n * kResStride + f] = acc[mt][j][0];
        sres[(n + 1) * kResStride + f] = acc[mt][j][1];
        sres[n * kResStride + f + 8] = acc[mt][j][2];
        sres[(n + 1) * kResStride + f + 8] = acc[mt][j][3];
      }
    __syncthreads();
    for (int e = tid; e < bpo * kFrames; e += kThreads) {
      const int bin = e / kFrames, f = e % kFrames;
      if (f0 + f < n_frames) {
        float v = sres[bin * kResStride + f];
        if constexpr (kStage == kFull) {
          const float s = sres[(bin + bpo) * kResStride + f];
          v = log1pf(sqrtf(v * v + s * s) * scales[bin]);
        }
        o[static_cast<long long>(bin) * n_frames + f0 + f] = v;
      }
    }
  }
}

// grid (frame tiles, clips, octaves); octave 0 reads x0, octave o >= 1 the
// arena at oct.offset[o]
template <typename T0, typename TS, int kStage>
__global__ void __launch_bounds__(kThreads, 3) octave_response_kernel(
    const T0* __restrict__ x0, long long x0_stride,
    const TS* __restrict__ arena, long long arena_stride, Octaves oct,
    int n_oct, const int* __restrict__ starts, int n_frames,
    const float* __restrict__ bank_hi, const float* __restrict__ bank_lo,
    const float* __restrict__ scales, int bpo, int n_fft,
    float* __restrict__ out, long long out_stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sst[kFrames];
  __shared__ int soff[kFrames];
  const int o = blockIdx.z;
  const long long b = blockIdx.y;
  float* dst = out + b * out_stride +
               static_cast<long long>(n_oct - 1 - o) * bpo * n_frames;
  const int* st = starts + static_cast<long long>(o) * n_frames;
  const float* sc = scales + o * bpo;
  if constexpr (std::is_same<T0, TS>::value) {
    const T0* x = o == 0 ? x0 + b * x0_stride
                         : arena + b * arena_stride + oct.offset[o];
    octave_body<T0, kStage>(x, oct.length[o], st, n_frames, bank_hi, bank_lo,
                            sc, bpo, n_fft, dst, smem, sst, soff);
  } else if (o == 0) {
    octave_body<T0, kStage>(x0 + b * x0_stride, oct.length[0], st, n_frames,
                            bank_hi, bank_lo, sc, bpo, n_fft, dst, smem, sst,
                            soff);
  } else {
    octave_body<TS, kStage>(arena + b * arena_stride + oct.offset[o],
                            oct.length[o], st, n_frames, bank_hi, bank_lo,
                            sc, bpo, n_fft, dst, smem, sst, soff);
  }
}

template <typename T0, typename TS, int kStage>
int launch(const void* x0, long long x0_stride, const void* arena,
           long long arena_stride, const Octaves& oct, int n_oct,
           const int* starts, int n_frames, const float* bank_hi,
           const float* bank_lo, const float* scales, int bpo, int n_fft,
           float* out, long long out_stride, int batch, cudaStream_t stream) {
  constexpr int smem = smem_bytes<T0, TS>();
  auto kernel = octave_response_kernel<T0, TS, kStage>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_frames + kFrames - 1) / kFrames, batch, n_oct);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T0*>(x0), x0_stride, static_cast<const TS*>(arena),
      arena_stride, oct, n_oct, starts, n_frames, bank_hi, bank_lo, scales,
      bpo, n_fft, out, out_stride);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

bool bad_geometry(int bpo, int n_fft, int n_frames, int batch) {
  return bpo < 1 || 2 * bpo > kMaxRows || n_fft < kChunk ||
         n_fft % kChunk != 0 || n_frames < 1 || batch < 1 || batch > 65535;
}

// the stage probe: one octave, T0 = TS = the stream's type
template <typename T>
int launch_stage(int stage, const void* buf, long long buf_stride,
                 const Octaves& oct, const int* starts, int n_frames,
                 const float* bank_hi, const float* bank_lo,
                 const float* scales, int bpo, int n_fft, float* out,
                 int batch, cudaStream_t s) {
  const long long out_stride = static_cast<long long>(bpo) * n_frames;
#define AKT_STAGE(S)                                                         \
  return launch<T, T, S>(buf, buf_stride, buf, buf_stride, oct, 1, starts,  \
                         n_frames, bank_hi, bank_lo, scales, bpo, n_fft, out, \
                         out_stride, batch, s);
  switch (stage) {
    case kLoad: AKT_STAGE(kLoad)
    case kRealign: AKT_STAGE(kRealign)
    case kGemm: AKT_STAGE(kGemm)
    case kFull: AKT_STAGE(kFull)
    default: return AKT_BAD_ARGS;
  }
#undef AKT_STAGE
}

}  // namespace

// Every octave in one launch. x0 (batch, x0_stride) octave 0's padded
// stream (int16 or float32); arena (batch, arena_stride) octaves >= 1 at
// offsets[o], lengths[o] columns each (float32 or bfloat16); starts
// (n_oct, n_frames); bank_hi / bank_lo (n_fft / 8, 32, 18) in fragment
// order; scales (n_oct, bpo); out (batch, n_oct * bpo, n_frames). Stream
// rows start 16-byte aligned and stay so (offsets and strides are
// multiples of 8 samples); every window lies inside its stream.
extern "C" int akt_octave_response(
    const void* x0, int x0_dtype, long long x0_stride, const void* arena,
    int arena_dtype, long long arena_stride, const long long* offsets,
    const int* lengths, int n_oct, const int* starts, int n_frames,
    const float* bank_hi, const float* bank_lo, const float* scales, int bpo,
    int n_fft, float* out, long long out_stride, int batch, void* stream) {
  if (bad_geometry(bpo, n_fft, n_frames, batch) || n_oct < 1 ||
      n_oct > kMaxOctaves || !aligned16(x0) || x0_stride % 8 != 0 ||
      (n_oct > 1 && (!aligned16(arena) || arena_stride % 8 != 0)))
    return AKT_BAD_ARGS;
  Octaves oct;
  for (int i = 0; i < n_oct; ++i) {
    if (i > 0 && offsets[i] % 8 != 0) return AKT_BAD_ARGS;
    oct.offset[i] = offsets[i];
    oct.length[i] = lengths[i];
  }
  auto s = static_cast<cudaStream_t>(stream);
#define AKT_LAUNCH(T0, TS)                                                  \
  return launch<T0, TS, kFull>(x0, x0_stride, arena, arena_stride, oct,    \
                               n_oct, starts, n_frames, bank_hi, bank_lo,  \
                               scales, bpo, n_fft, out, out_stride, batch, \
                               s);
  if (x0_dtype == AKT_I16 && arena_dtype == AKT_BF16) AKT_LAUNCH(int16_t, __nv_bfloat16)
  if (x0_dtype == AKT_I16 && arena_dtype == AKT_F32) AKT_LAUNCH(int16_t, float)
  if (x0_dtype == AKT_F32 && arena_dtype == AKT_BF16) AKT_LAUNCH(float, __nv_bfloat16)
  if (x0_dtype == AKT_F32 && arena_dtype == AKT_F32) AKT_LAUNCH(float, float)
#undef AKT_LAUNCH
  return AKT_BAD_ARGS;
}

// One stage of the probe on one octave's stream (int16, float32 or
// bfloat16; `length` columns) into a (batch, bpo, n_frames) float32 tensor.
extern "C" int akt_octave_response_stage(
    const void* buf, int in_dtype, long long buf_stride, int length,
    const int* starts, int n_frames, const float* bank_hi,
    const float* bank_lo, const float* scales, int bpo, int n_fft,
    float* out, int stage, int batch, void* stream) {
  if (bad_geometry(bpo, n_fft, n_frames, batch) || !aligned16(buf) ||
      buf_stride % 8 != 0)
    return AKT_BAD_ARGS;
  Octaves oct;
  oct.offset[0] = 0;
  oct.length[0] = length;
  auto s = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case AKT_F32:
      return launch_stage<float>(stage, buf, buf_stride, oct, starts,
                                 n_frames, bank_hi, bank_lo, scales, bpo,
                                 n_fft, out, batch, s);
    case AKT_BF16:
      return launch_stage<__nv_bfloat16>(stage, buf, buf_stride, oct, starts,
                                         n_frames, bank_hi, bank_lo, scales,
                                         bpo, n_fft, out, batch, s);
    case AKT_I16:
      return launch_stage<int16_t>(stage, buf, buf_stride, oct, starts,
                                   n_frames, bank_hi, bank_lo, scales, bpo,
                                   n_fft, out, batch, s);
    default:
      return AKT_BAD_ARGS;
  }
}
