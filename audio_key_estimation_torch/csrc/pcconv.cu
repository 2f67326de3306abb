// One eval-mode float32 conv of a transposition-equivariant pitch-class
// stack (PitchClass2PitchClass, ConvStack(equivariant=True)): the
// reference's EquivariantPitchClassConvolutionSimple with
// same_depth_padding, 12 x 7 over the 12 pitch classes, circular on pitch
// (mod 12) and zero-padded by 3 on time, plus the conv's bias, eval
// BatchNorm as a per-channel scale and shift, in a residual block's second
// conv the block's input added, then leaky-ReLU 0.01:
//
//   y[n, co, p, t] = leaky(((sum over ci, dp < 12, dt < 7 of
//                    w[co, ci, dp, dt] * x[n, ci, (p + dp) mod 12, t + dt - 3])
//                    + bias[co]) * scale[co] + shift[co] (+ skip[n, co, p, t]))
//
// A plain stack is one launch a conv (1 -> 4, 4 -> 4 in layer 0; 12 -> 16,
// 16 -> 16 in layer 1 at the published widths), a residual one a stem and
// two a block (4 -> 8, 8 -> 4 + skip; 16 -> 32, 32 -> 16 + skip)
// (ops/pcstack_cuda.pc_stack).
//
// IEEE float32 throughout: FFMA on the CUDA cores, float32 operands and
// sums, no tensor-core instruction (no TF32, no split, no bf16), as the
// configurations state for these stacks. BatchNorm is not folded into the
// weights: the epilogue computes ((sum + bias) * scale + shift), scale =
// gamma / sqrt(var + eps), shift = beta - mean * scale, as resconv7.cu.
//
// Replaces no Pallas kernel: the JAX package runs these convs through XLA
// (a concatenation of 11 wrapped rows, then a lax convolution). It was
// added because cuDNN's float32 path (the same concatenation, then
// implicit_convolve_sgemm over 23 rows, then separate BatchNorm, add and
// leaky-ReLU passes) ran these stacks at 4-21% of their float32 bound.
//
// What bounds it on the H100. 2 * 84 * cin * cout FLOP a position against
// 4 * (cin + cout (+ cout for the skip)) bytes of device memory: over 300
// FLOP a byte at 16 -> 16, far above the card's 20 at 67 TFLOP/s and 3.35
// TB/s. So the FFMA issue rate sets the time, and the design keeps the
// FFMA stream dense and writes no padded tensor:
//
//  * A thread computes 8 output channels (4 where cout is 4) x all 12
//    pitch rows x 1 time position: 96 float32 accumulators (48). For each
//    input channel and tap dt it loads its 12 input rows at its time (12
//    shared loads; consecutive lanes read consecutive times, no bank
//    conflict), and for each pitch shift dp the 8 weights as two 16-byte
//    broadcast loads; then 96 FFMA. The circular shift (p + dp) mod 12 is a
//    compile-time register index of the fully unrolled p x dp loop, so the
//    wrap costs no instruction and no memory. 36 shared loads to 1152
//    FFMA.
//  * A block of 8 warps computes a tile of all output channels (split over
//    warps in groups of 8) x 12 rows x 64-256 time positions. The time
//    axes of the batch's clips are laid end to end with 3 zero columns
//    between clips (position v = clip * (T + 3) + t), which serve as both
//    neighbours' zero pad; tiles cut that axis evenly, so no tile is
//    ragged at a clip's end and only 3 of T + 3 positions are wasted.
//  * Each stage of a block's stream is one (tile, input channel): its 12
//    input rows over the tile and a 6-column halo, and that channel's
//    weights ([dt][dp][co], 7 * 12 * cout floats), copied by cp.async into
//    a ring of three buffers two stages ahead; columns in a gap or past
//    the batch are written as zeros. Blocks are persistent (two an SM),
//    so the next tile's first channels load while this one finishes.
//  * The epilogue needs no shared memory: a warp's lanes already hold
//    consecutive time positions, so each (channel, row) store, and the
//    skip's read, is 32 consecutive floats.
//
// Layouts: input, skip and output NCHW float32 (B, C, 12, T), the stack's
// own; weights (cin, 7, 12, cout). Device memory a conv moves: its input
// (with the halo's re-reads from L2), its output, the skip once and each
// tile's weights from L2.
#include <algorithm>
#include <atomic>
#include <climits>

#include "common.cuh"

namespace {

constexpr int kPC = 12;     // pitch classes: the circular axis
constexpr int kKT = 7;      // taps on time
constexpr int kPad = 3;     // zero pad on time, and the gap between clips
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;  // the ring: one (tile, input channel) a stage
constexpr int kMaxDevices = 64;

template <int CIN, int COUT>
struct Geo {
  static constexpr int kCo = COUT < 8 ? COUT : 8;   // channels a thread
  static constexpr int kGroups = COUT / kCo;        // warps on one chunk
  static constexpr int kChunks = kWarps / kGroups;  // 32-position chunks
  static constexpr int kTileT = kChunks * 32;
  static constexpr int kHaloT = kTileT + 2 * kPad;
  static constexpr int kStride = (kHaloT + 3) / 4 * 4;
  static constexpr int kIn = kPC * kStride;   // a stage's input rows
  static constexpr int kW = kKT * kPC * COUT;  // one input channel's weights
  static constexpr int kStage = kIn + kW;
  static constexpr int kSmemBytes = 4 * kStages * kStage;
  static constexpr int kCols = (kHaloT + kThreads - 1) / kThreads;
  static_assert(kCo % 4 == 0 && COUT % kCo == 0 && kWarps % kGroups == 0,
                "channel groups");
};

struct PcConvArgs {
  const float* x;      // (B, CIN, 12, T)
  const float* w;      // (CIN, 7, 12, COUT)
  const float* bias;   // (COUT,) the conv's
  const float* scale;  // (COUT,) BatchNorm's
  const float* shift;  // (COUT,)
  const float* skip;   // (B, COUT, 12, T) or null
  float* y;            // (B, COUT, 12, T)
  int T, TV, V;        // TV = T + 3 a clip on the joined axis, V = B * TV
  int n_tiles;
};

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stages input channel ci of a tile into buf: row q, column j holds the
// input at pitch class q and joined position tile * kTileT - 3 + j (zero
// in a gap or outside the batch); then the channel's weights. Thread i
// copies columns i, i + 256, ...
template <int CIN, int COUT>
__device__ __forceinline__ void issue(const PcConvArgs& a, int tile, int ci,
                                      float* buf) {
  using G = Geo<CIN, COUT>;
  const float* wsrc = a.w + static_cast<long long>(ci) * G::kW;
  for (int i = threadIdx.x; i < G::kW / 4; i += kThreads)
    cp_async16(akt_smem_u32(buf + G::kIn + 4 * i), wsrc + 4 * i);
  const int v0 = tile * G::kTileT - kPad;
#pragma unroll
  for (int m = 0; m < G::kCols; ++m) {
    const int j = threadIdx.x + kThreads * m;
    if (j >= G::kHaloT) break;
    const int v = v0 + j;
    const int clip = v >= 0 ? v / a.TV : 0;
    const int t = v - clip * a.TV;
    float* dst = buf + j;
    if (v >= 0 && v < a.V && t < a.T) {
      const float* src =
          a.x + (static_cast<long long>(clip) * CIN + ci) * kPC * a.T + t;
      const uint32_t d = akt_smem_u32(dst);
#pragma unroll
      for (int q = 0; q < kPC; ++q)
        cp_async4(d + 4 * q * G::kStride, src + q * a.T);
    } else {
#pragma unroll
      for (int q = 0; q < kPC; ++q) dst[q * G::kStride] = 0.f;
    }
  }
}

// One input channel's share of a thread's sums: in is the stage's input at
// the thread's first column (tap dt reads column + dt), w the channel's
// weights at the thread's first output channel.
template <int CIN, int COUT>
__device__ __forceinline__ void accumulate(
    const float* in, const float* w,
    float (&acc)[Geo<CIN, COUT>::kCo][kPC]) {
  using G = Geo<CIN, COUT>;
#pragma unroll 1
  for (int dt = 0; dt < kKT; ++dt, ++in, w += kPC * COUT) {
    float x[kPC];
#pragma unroll
    for (int q = 0; q < kPC; ++q) x[q] = in[q * G::kStride];
#pragma unroll
    for (int dp = 0; dp < kPC; ++dp) {
      float wv[G::kCo];
#pragma unroll
      for (int c4 = 0; c4 < G::kCo / 4; ++c4) {
        const float4 q4 =
            *reinterpret_cast<const float4*>(w + dp * COUT + 4 * c4);
        wv[4 * c4] = q4.x;
        wv[4 * c4 + 1] = q4.y;
        wv[4 * c4 + 2] = q4.z;
        wv[4 * c4 + 3] = q4.w;
      }
#pragma unroll
      for (int p = 0; p < kPC; ++p)
#pragma unroll
        for (int c = 0; c < G::kCo; ++c)
          acc[c][p] = fmaf(wv[c], x[(p + dp) % kPC], acc[c][p]);
    }
  }
}

// A tile's outputs: each lane finishes and stores its own position; a
// warp's 32 lanes write 32 consecutive times of one (channel, row).
template <int CIN, int COUT, bool SKIP>
__device__ __forceinline__ void finish(
    const PcConvArgs& a, int tile, const float (&acc)[Geo<CIN, COUT>::kCo][kPC],
    int g, int k, int lane) {
  using G = Geo<CIN, COUT>;
  const int v = tile * G::kTileT + k * 32 + lane;
  const int clip = v / a.TV, t = v - clip * a.TV;
  if (v >= a.V || t >= a.T) return;
  const long long at =
      (static_cast<long long>(clip) * COUT + g * G::kCo) * kPC * a.T + t;
#pragma unroll
  for (int c = 0; c < G::kCo; ++c) {
    const int co = g * G::kCo + c;
    const float b = __ldg(a.bias + co), s = __ldg(a.scale + co),
                h = __ldg(a.shift + co);
#pragma unroll
    for (int p = 0; p < kPC; ++p) {
      const long long i = at + static_cast<long long>(c * kPC + p) * a.T;
      float y = fmaf(acc[c][p] + b, s, h);
      if constexpr (SKIP) y += __ldg(a.skip + i);
      a.y[i] = y >= 0.f ? y : 0.01f * y;
    }
  }
}

template <int CIN, int COUT, bool SKIP>
__global__ void __launch_bounds__(kThreads, 2)
    pitch_class_conv_kernel(const PcConvArgs a) {
  using G = Geo<CIN, COUT>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);  // kStages stages
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = warp / G::kChunks, k = warp - g * G::kChunks;
  if (static_cast<int>(blockIdx.x) >= a.n_tiles) return;
  const int n_stages =
      ((a.n_tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1) * CIN;

  int ld_tile = blockIdx.x, ld_ci = 0;
  // stage s of the block's (tile, channel) stream into buffer s % kStages;
  // one commit group per call, empty past the stream's end
  const auto issue_stage = [&](int s) {
    if (s < n_stages) {
      issue<CIN, COUT>(a, ld_tile, ld_ci, smem + (s % kStages) * G::kStage);
      if (++ld_ci == CIN) {
        ld_ci = 0;
        ld_tile += gridDim.x;
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue_stage(s);

  float acc[G::kCo][kPC];
  int tile = blockIdx.x, ci = 0;
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage s
    __syncthreads();  // everyone's; and stage s - 1's buffer is free
    issue_stage(s + kStages - 1);
    if (ci == 0) {
#pragma unroll
      for (int c = 0; c < G::kCo; ++c)
#pragma unroll
        for (int p = 0; p < kPC; ++p) acc[c][p] = 0.f;
    }
    const float* buf = smem + (s % kStages) * G::kStage;
    if (tile * G::kTileT + k * 32 < a.V)  // warp-uniform
      accumulate<CIN, COUT>(buf + k * 32 + lane,
                            buf + G::kIn + g * G::kCo, acc);
    if (++ci == CIN) {
      finish<CIN, COUT, SKIP>(a, tile, acc, g, k, lane);
      ci = 0;
      tile += gridDim.x;
    }
  }
}

template <int CIN, int COUT, bool SKIP>
int run(PcConvArgs a, cudaStream_t stream) {
  using G = Geo<CIN, COUT>;
  const auto kernel = pitch_class_conv_kernel<CIN, COUT, SKIP>;
  a.n_tiles = static_cast<int>((static_cast<long long>(a.V) + G::kTileT - 1) /
                               G::kTileT);
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

}  // namespace

// x (B, cin, 12, T), w (cin, 7, 12, cout) (16-byte aligned) and y (B, cout,
// 12, T) float32, contiguous; bias, scale, shift (cout,); skip (B, cout,
// 12, T) for a residual block's second conv, else null. (cin, cout, skip)
// is one of ops/pcstack_cuda.CONVS.
extern "C" int akt_pcconv(const float* x, const float* w, const float* bias,
                          const float* scale, const float* shift,
                          const float* skip, float* y, int cin, int cout,
                          int batch, int H, int T, void* stream) {
  const long long joined = static_cast<long long>(batch) * (T + kPad);
  if (batch < 1 || H != kPC || T < 1 || joined > INT_MAX - 1024 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return AKT_BAD_ARGS;
  const PcConvArgs a{x, w, bias, scale, shift, skip, y,
                     T, T + kPad, static_cast<int>(joined), 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool k = skip != nullptr;
  if (cin == 1 && cout == 4 && !k) return run<1, 4, false>(a, s);
  if (cin == 4 && cout == 4 && !k) return run<4, 4, false>(a, s);
  if (cin == 4 && cout == 8 && !k) return run<4, 8, false>(a, s);
  if (cin == 8 && cout == 4 && k) return run<8, 4, true>(a, s);
  if (cin == 12 && cout == 16 && !k) return run<12, 16, false>(a, s);
  if (cin == 16 && cout == 16 && !k) return run<16, 16, false>(a, s);
  if (cin == 16 && cout == 32 && !k) return run<16, 32, false>(a, s);
  if (cin == 32 && cout == 16 && k) return run<32, 16, true>(a, s);
  return AKT_BAD_ARGS;
}
