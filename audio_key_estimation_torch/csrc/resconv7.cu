// One eval-mode float32 conv of a residual Pitch2Pitch stack (--resblock):
// 7x7 convolution, circular on pitch (H) and time (T) with pad 3, plus the
// conv's bias, eval BatchNorm as a per-channel scale and shift, in a
// block's second conv the block's input added, then leaky-ReLU 0.01. The
// three convs of such a stack: the stem (cin 5 -> 8), a block's first conv
// (8 -> 16) and its second (16 -> 8, with the skip), so a stack of three
// blocks is seven launches (ops/resstack_cuda.residual_stack).
//
// IEEE float32 throughout: FFMA on the CUDA cores, float32 operands and
// float32 sums, no tensor-core instruction (no TF32, no split, no bf16), as
// the configurations state for these stacks. BatchNorm is not folded into
// the weights: the conv runs on the module's own weights and the epilogue
// computes ((sum + bias) * scale + shift), scale = gamma / sqrt(var + eps)
// and shift = beta - mean * scale, the order torch's eval batch_norm uses.
//
// Replaces no Pallas kernel: the JAX package runs these convs through XLA
// (its Pitch2Pitch residual blocks are lax convolutions on wrapped pads).
// It was added because cuDNN's float32 path (implicit_convolve_sgemm, plus
// two concatenations a conv for the circular pad and separate BatchNorm,
// add and leaky-ReLU passes) ran the stack at about a tenth of its bound.
//
// What bounds it on the H100. Operations: 2 * 49 * cin * cout FLOP a
// position, 12,544 for 8 -> 16 and 16 -> 8, against 4 * (cin + cout (+ 8
// for the skip)) bytes a position in device memory: over 300 FLOP a byte,
// far above the card's 20 FLOP a byte at 67 TFLOP/s float32 and 3.35
// TB/s. So the FFMA issue rate sets the time, and the design keeps the
// FFMA stream dense:
//
//  * A thread computes 8 output channels x 16 consecutive time positions of
//    one pitch row: 128 float32 accumulators in registers. For each input
//    channel and kernel row dh it loads a 22-float window of its input row
//    once (five 16-byte and one 8-byte shared loads), and for each tap dw
//    the 8 weights as two 16-byte broadcast loads (every lane of a warp
//    reads the same address); then 8 x 16 FFMA reuse them. That is 20
//    shared loads to 896 FFMA, about 2% other instructions.
//  * A block of 4 warps owns a tile of 32 pitch rows (one per lane) x 64
//    time positions x all 8 output channels, or 32 x 32 x 16 (two warps
//    per 8 channels). Lanes of a warp are consecutive rows, and a halo row
//    in shared memory is an odd number of 16-byte chunks long, so the 8
//    lanes of each quarter-warp read 8 distinct bank groups.
//  * All weights sit in shared memory ([ci][dh][dw][co], 25 KB at 16 x 8 x
//    49), loaded once per block. The input halo ((32 + 6) x (tile + 6)
//    positions) is staged one input channel at a time into a ring of three
//    buffers by cp.async, two channels ahead, and across tiles: blocks are
//    persistent and a block's tiles form one stream of (tile, channel)
//    stages, so the next tile's first channels load while this one
//    finishes. The circular wrap on both axes is index arithmetic on the
//    copy (each element is a 4-byte copy from its wrapped address: rows of
//    T = 901 floats are not 16-byte aligned); no padded tensor is written.
//  * The epilogue goes through shared memory, one output channel a round,
//    so that consecutive lanes store (and, for the skip, read) consecutive
//    time positions: a thread's own 16 positions are 64 bytes apart from
//    its neighbours'. The skip's values of the next round are copied into
//    shared memory by cp.async while this round is stored: read directly,
//    their latency cost the 16 -> 8 conv a fifth of its time. A ragged
//    last time tile and an H that is not a multiple of 32 are masked on
//    the store; a warp whose 16 positions all lie beyond T skips its FFMA.
//
// At the resblock.resident cell's shapes (256 clips, H 288, T 901) the
// three convs run at 53%, 61% and 61% of the float32 bound at 1980 MHz
// (PERF.md). Measured no faster: 2-warp blocks, 8 positions a thread (128
// registers, 4 blocks an SM), a fully unrolled kernel-row loop, a
// two-buffer ring, two or four channels an epilogue round.
//
// Layouts: every input, skip and output is NCHW float32 (B, C, H, T), the
// stack's own; activations between convs are the same, so no layout pass
// runs. Device memory a conv moves: its input once, its output once, the
// skip once (4 * B * H * T * (cin + cout (+ cout)) bytes) and the weights
// once a block; the halo's re-reads (38 / 32 x 70 / 64, or 38 / 32 x 38 /
// 32) come from L2.
#include <algorithm>
#include <atomic>

#include "common.cuh"

namespace {

constexpr int kK = 7;
constexpr int kPad = 3;
constexpr int kP = 16;      // consecutive time positions a thread computes
constexpr int kCo = 8;      // output channels a thread computes
constexpr int kRows = 32;   // pitch rows a tile: one per lane
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;   // the halo ring: one input channel a stage
constexpr int kWin = kP + kK - 1;  // 22 floats of input a thread's row needs
constexpr int kMaxDevices = 64;

template <int CIN, int COUT, bool SKIP>
struct Geo {
  static constexpr int kGroups = COUT / kCo;        // warps on one time chunk
  static constexpr int kChunks = kWarps / kGroups;  // 16-position chunks
  static constexpr int kTileT = kChunks * kP;
  static constexpr int kHaloH = kRows + 2 * kPad;
  static constexpr int kHaloT = kTileT + 2 * kPad;
  // a halo row: at least kHaloT floats, an odd number of 16-byte chunks
  static constexpr int kStride = ((kHaloT + 3) / 4 | 1) * 4;
  static constexpr int kHalo = kHaloH * kStride;
  static constexpr int kW = CIN * kK * kK * COUT;
  // the epilogue's rows: an odd number of 16-byte chunks too
  static constexpr int kOutStride = (kTileT / 4 + 1 | 1) * 4;
  static constexpr int kRuns = kGroups * kRows;  // (channel group, row) runs
  static constexpr int kMine = kRuns * kTileT / kThreads;  // a thread's
                                                           // runs a round
  static constexpr int kSkip = SKIP ? 2 * kMine * kThreads : 0;
  static constexpr int kSmemBytes =
      4 * (kW + kStages * kHalo + kRuns * kOutStride + kSkip);
  static constexpr int kCols = (kHaloT + 31) / 32;  // halo columns a lane
  static constexpr int kRunStep = kThreads / kTileT;
  static_assert(COUT % kCo == 0 && kThreads % kTileT == 0, "tile shape");
  static_assert(kW % 4 == 0 && kHalo % 4 == 0, "16-byte aligned buffers");
};

struct ResConvArgs {
  const float* x;      // (B, CIN, H, T)
  const float* w;      // (CIN, 7, 7, COUT)
  const float* bias;   // (COUT,) the conv's
  const float* scale;  // (COUT,) BatchNorm's
  const float* shift;  // (COUT,)
  const float* skip;   // (B, COUT, H, T) or null
  float* y;            // (B, COUT, H, T)
  int H, T, n_rows, n_times, n_tiles;
};

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Tile {
  int b, h0, t0;
};

template <class G>
__device__ __forceinline__ Tile tile_at(const ResConvArgs& a, int tile) {
  const int tt = tile % a.n_times;
  const int rest = tile / a.n_times;
  return {rest / a.n_rows, (rest % a.n_rows) * kRows, tt * G::kTileT};
}

// Stages one input channel of a tile's halo: buffer row r, column j holds
// the input at pitch row h0 - 3 + r and time t0 - 3 + j, both wrapped. Warp
// w copies rows w, w + 4, ...; lane l columns l, l + 32, ...
template <class G, int CIN>
struct Loader {
  const float* clip;  // the tile's clip, channel 0
  int h;              // the wrapped pitch row of this warp's first halo row
  int col[G::kCols];  // the wrapped times of this lane's halo columns

  __device__ __forceinline__ void start(const ResConvArgs& a, int tile,
                                        int warp, int lane) {
    const Tile tl = tile_at<G>(a, tile);
    clip = a.x + static_cast<long long>(tl.b) * CIN * a.H * a.T;
    h = wrap(tl.h0 - kPad + warp, a.H);
#pragma unroll
    for (int m = 0; m < G::kCols; ++m)
      col[m] = wrap(tl.t0 - kPad + lane + 32 * m, a.T);
  }

  __device__ __forceinline__ void issue(const ResConvArgs& a, int ci,
                                        float* buf, int warp,
                                        int lane) const {
    const float* src = clip + static_cast<long long>(ci) * a.H * a.T;
    int hh = h;
    for (int r = warp; r < G::kHaloH; r += kWarps) {
      const float* row = src + hh * a.T;
      const uint32_t dst = akt_smem_u32(buf + r * G::kStride + lane);
#pragma unroll
      for (int m = 0; m < G::kCols; ++m)
        if (lane + 32 * m < G::kHaloT) cp_async4(dst + 128 * m, row + col[m]);
      hh += kWarps;
      while (hh >= a.H) hh -= a.H;
    }
  }
};

// One input channel's share of a thread's 8 x 16 sums: in is the thread's
// output row's first halo row at its chunk, wci the channel's weights at
// the thread's first output channel.
template <int COUT>
__device__ __forceinline__ void accumulate(const float* in, const float* wci,
                                           float (&acc)[kCo][kP],
                                           int stride) {
#pragma unroll 1
  for (int dh = 0; dh < kK; ++dh, in += stride, wci += kK * COUT) {
    float v[kWin];
#pragma unroll
    for (int i = 0; i < kWin / 4; ++i) {
      const float4 q = *reinterpret_cast<const float4*>(in + 4 * i);
      v[4 * i] = q.x;
      v[4 * i + 1] = q.y;
      v[4 * i + 2] = q.z;
      v[4 * i + 3] = q.w;
    }
    const float2 e = *reinterpret_cast<const float2*>(in + kWin - 2);
    v[kWin - 2] = e.x;
    v[kWin - 1] = e.y;
#pragma unroll
    for (int dw = 0; dw < kK; ++dw) {
      const float4 wa = *reinterpret_cast<const float4*>(wci + dw * COUT);
      const float4 wb = *reinterpret_cast<const float4*>(wci + dw * COUT + 4);
      const float w[kCo] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int c = 0; c < kCo; ++c)
#pragma unroll
        for (int p = 0; p < kP; ++p)
          acc[c][p] = fmaf(w[c], v[p + dw], acc[c][p]);
    }
  }
}

// A tile's outputs, one output channel of each group a round: the sums go
// to the shared tile out, then each (channel, row) run is finished and
// stored by consecutive lanes; a thread keeps one time position t of the
// tile and steps through the runs. In a block's second conv each thread
// copies the skip values it will add into shared memory by cp.async, a
// round ahead (its own values: no barrier guards them).
template <int CIN, int COUT, bool SKIP>
__device__ __forceinline__ void finish(const ResConvArgs& a, int tile,
                                       float (&acc)[kCo][kP], float* out,
                                       float* skip, int lane, int k, int g) {
  using G = Geo<CIN, COUT, SKIP>;
  const Tile tl = tile_at<G>(a, tile);
  const int t = threadIdx.x % G::kTileT, run0 = threadIdx.x / G::kTileT;
  const bool live = tl.t0 + t < a.T;
  const int rows = live ? min(kRows, a.H - tl.h0) : 0;
  const long long plane = static_cast<long long>(a.H) * a.T;
  // channel 0, the tile's first row, this thread's time
  const long long at0 =
      (static_cast<long long>(tl.b) * COUT * a.H + tl.h0) * a.T + tl.t0 + t;
  const auto at = [&](int run, int c) {
    return at0 + (run / kRows * kCo + c) * plane + run % kRows * a.T;
  };
  const auto fetch = [&](int c) {
    float* mine = skip + (c & 1) * G::kMine * kThreads + threadIdx.x;
#pragma unroll 4
    for (int i = 0; i < G::kMine; ++i) {
      const int run = run0 + i * G::kRunStep;
      if (run % kRows < rows)
        cp_async4(akt_smem_u32(mine + i * kThreads), a.skip + at(run, c));
    }
    cp_async_commit();
  };
  if constexpr (SKIP) fetch(0);
  float* mine = out + (g * kRows + lane) * G::kOutStride + k * kP;
#pragma unroll
  for (int c = 0; c < kCo; ++c) {
    if constexpr (SKIP) {
      if (c + 1 < kCo)
        fetch(c + 1);
      else
        cp_async_commit();
    }
#pragma unroll
    for (int q = 0; q < kP / 4; ++q)
      *reinterpret_cast<float4*>(mine + 4 * q) =
          make_float4(acc[c][4 * q], acc[c][4 * q + 1], acc[c][4 * q + 2],
                      acc[c][4 * q + 3]);
    if constexpr (SKIP) cp_async_wait<1>();  // this round's skip values
    __syncthreads();
    const float* sk = skip + (c & 1) * G::kMine * kThreads + threadIdx.x;
#pragma unroll 4
    for (int i = 0; i < G::kMine; ++i) {
      const int run = run0 + i * G::kRunStep;
      if (run % kRows >= rows) continue;
      const int co = run / kRows * kCo + c;
      float v = out[run * G::kOutStride + t] + __ldg(a.bias + co);
      v = fmaf(v, __ldg(a.scale + co), __ldg(a.shift + co));
      if constexpr (SKIP) v += sk[i * kThreads];
      a.y[at(run, c)] = v >= 0.f ? v : 0.01f * v;
    }
    __syncthreads();  // the shared tile is rewritten next round
  }
}

template <int CIN, int COUT, bool SKIP>
__global__ void __launch_bounds__(kThreads, 2)
    residual_conv_kernel(const ResConvArgs a) {
  using G = Geo<CIN, COUT, SKIP>;
  extern __shared__ float4 smem4[];
  float* wsm = reinterpret_cast<float*>(smem4);  // [ci][dh][dw][co]
  float* halo = wsm + G::kW;                     // kStages buffers
  float* out = halo + kStages * G::kHalo;        // the epilogue's tile
  float* skip = out + G::kRuns * G::kOutStride;  // two rounds' skip values
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = warp / G::kChunks, k = warp - g * G::kChunks;
  if (static_cast<int>(blockIdx.x) >= a.n_tiles) return;
  const int n_stages =
      ((a.n_tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1) * CIN;
  for (int i = threadIdx.x; i < G::kW; i += kThreads)
    wsm[i] = __ldg(a.w + i);

  Loader<G, CIN> ld;
  int ld_tile = blockIdx.x, ld_ci = 0;
  ld.start(a, ld_tile, warp, lane);
  // stage s of the block's (tile, channel) stream into buffer s % kStages;
  // one commit group per call, empty past the stream's end
  const auto issue = [&](int s) {
    if (s < n_stages) {
      ld.issue(a, ld_ci, halo + (s % kStages) * G::kHalo, warp, lane);
      if (++ld_ci == CIN) {
        ld_ci = 0;
        ld_tile += gridDim.x;
        if (ld_tile < a.n_tiles) ld.start(a, ld_tile, warp, lane);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  float acc[kCo][kP];
  int tile = blockIdx.x, ci = 0;
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage s
    __syncthreads();  // everyone's; and stage s - 1's buffer is free
    issue(s + kStages - 1);
    if (ci == 0) {
#pragma unroll
      for (int c = 0; c < kCo; ++c)
#pragma unroll
        for (int p = 0; p < kP; ++p) acc[c][p] = 0.f;
    }
    const Tile tl = tile_at<G>(a, tile);
    if (tl.t0 + k * kP < a.T)  // warp-uniform: a ragged last tile
      accumulate<COUT>(halo + (s % kStages) * G::kHalo + lane * G::kStride +
                           k * kP,
                       wsm + ci * kK * kK * COUT + g * kCo, acc, G::kStride);
    if (++ci == CIN) {
      finish<CIN, COUT, SKIP>(a, tile, acc, out, skip, lane, k, g);
      ci = 0;
      tile += gridDim.x;
    }
  }
}

template <int CIN, int COUT, bool SKIP>
int launch(const ResConvArgs& a, cudaStream_t stream) {
  using G = Geo<CIN, COUT, SKIP>;
  const auto kernel = residual_conv_kernel<CIN, COUT, SKIP>;
  // set up once per device: the shared-memory attribute (per context) and
  // the persistent grid, as many blocks as an SM holds; 0 until then
  static std::atomic<int> blocks[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return AKT_BAD_ARGS;
  int grid = blocks[dev].load(std::memory_order_relaxed);
  if (grid == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             G::kSmemBytes)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, G::kSmemBytes)) != cudaSuccess)
      return static_cast<int>(err);
    if (per_sm < 1) return AKT_BAD_ARGS;
    grid = per_sm * sms;
    blocks[dev].store(grid, std::memory_order_relaxed);
  }
  kernel<<<std::min(grid, a.n_tiles), kThreads, G::kSmemBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int CIN, int COUT, bool SKIP>
int run(ResConvArgs a, int batch, cudaStream_t stream) {
  constexpr int kTileT = Geo<CIN, COUT, SKIP>::kTileT;
  a.n_times = (a.T + kTileT - 1) / kTileT;
  const long long tiles = static_cast<long long>(batch) * a.n_rows * a.n_times;
  if (tiles > 0x7fffffff) return AKT_BAD_ARGS;
  a.n_tiles = static_cast<int>(tiles);
  return launch<CIN, COUT, SKIP>(a, stream);
}

}  // namespace

// x (B, cin, H, T), w (cin, 7, 7, cout) and y (B, cout, H, T) float32,
// contiguous; bias, scale, shift (cout,); skip (B, cout, H, T) for the
// block's second conv, else null. (cin, cout, skip) is one of (5, 8, no),
// (8, 16, no), (16, 8, yes).
extern "C" int akt_resconv7(const float* x, const float* w, const float* bias,
                            const float* scale, const float* shift,
                            const float* skip, float* y, int cin, int cout,
                            int batch, int H, int T, void* stream) {
  if (batch < 1 || H < 3 || T < 3 ||
      static_cast<long long>(H) * T > 0x7fffffff)
    return AKT_BAD_ARGS;
  const ResConvArgs a{x, w, bias, scale, shift, skip, y, H, T,
                      (H + kRows - 1) / kRows, 0, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool has_skip = skip != nullptr;
  if (cin == 5 && cout == 8 && !has_skip) return run<5, 8, false>(a, batch, s);
  if (cin == 8 && cout == 16 && !has_skip) return run<8, 16, false>(a, batch, s);
  if (cin == 16 && cout == 8 && has_skip) return run<16, 8, true>(a, batch, s);
  return AKT_BAD_ARGS;
}
