// Kernel C — one eval-mode Pitch2Pitch layer: 7x7 convolution, circular on
// pitch (H) and time (T), BatchNorm folded into weights and bias,
// leaky-ReLU 0.01. bf16 operands, float32 sums.
//
// Replaces audio_key_estimation_tpu/ops/convstack_pallas.py::_conv7_layer.
//
// Layouts. Between layers the activations are channels-last (B, H, T, 8)
// bf16, one position's 8 channels one 16-byte row. The stack's first layer
// reads its NCHW input (B, cin, H, T) in the input's dtype (float32 or
// bf16), rounds it to bf16 on load (the JAX package's astype(bfloat16))
// and zero-fills channels cin..7 in shared memory; its last layer writes
// NCHW (B, 8, H, T) in the stack's dtype from the bf16-rounded value
// (y.astype(dtype)). So no layout pass runs outside the three launches.
// Weights arrive with BatchNorm folded in float32, cast to bf16 and packed
// once per stack on the host (ops/convstack_cuda.pack_weight) in the
// mma's B-fragment order: [dh 7][tap pair p 4][half 2][co 8][ci 8], tap
// dt = 2p + half, dt 7 and ci >= cin zero; lane l's word of (dh, p, half)
// is word l of that 32-word row.
//
// Implicit GEMM on the tensor cores with mma.sync (bf16 -> f32): M = 16
// consecutive time positions, N = the 8 output channels, K = (time tap
// pair, 8 ci): m16n8k16 for the pairs (0,1), (2,3), (4,5) and m16n8k8 for
// tap 6 alone. A warp owns kRows output pitch rows x 16 positions and keeps
// kRows accumulators. It walks the kRows + 6 input rows; for each input row
// and tap pair it loads ONE A fragment with ldmatrix (rows are positions,
// 16 bytes each; matrices 2 and 3 are matrices 0 and 1 shifted by one
// position, the pair's second tap) and feeds it to the mma of every output
// row h with dh = r - h in [0, 6], with the B fragment of (dh, p); the next
// step's fragment is loaded before this step's mma are issued. The 49 B
// fragment registers are loaded once per block.
//
// What bounds it on the H100. Device memory: 16 B read and 16 B written
// per position between layers (the first layer reads cin x 4 B, the last
// writes 32 B of float32). Before this design each mma read its whole A
// fragment from shared memory (25 k-steps per 16 positions, no reuse):
// the shared-memory load rate, not bytes or FLOPs, set its time. Here a
// fragment serves up to 7 output rows: 14 ldmatrix matrices per input row
// and 16 positions, the fewest this register layout allows, against 100.
// Measured (PERF.md, PR 5), the mma alone and the ldmatrix alone each run
// near their peak, but together they do not overlap; that, and the bytes
// at about 2.3 TB/s, set the time.
//
// Blocks are persistent (kBlocksPerSm per SM): a block loads its weights
// once, then walks tiles of kRows rows x kTileT positions of one clip
// (time fastest); while tile k computes, tile k + 1's halo ((kRows + 6) x
// (kTileT + 6) positions) is in flight: by cp.async, 16 bytes per
// position, into a two-buffer ring for a channels-last input; by plain
// loads, rounded to bf16, for an NCHW one (copying it by cp.async into a
// float ring measured no faster). The circular wrap on both axes is index
// arithmetic on that copy, so no padded activation is ever written. A
// ragged last time tile and an H that is not a multiple of kRows are
// masked on the store. An NCHW output goes through a tile in shared
// memory, so each (row, channel) run of the tile is stored by consecutive
// lanes (from the fragments, a warp's store covers eight 32-byte pieces
// of four channel rows). The TPU's 2.04x block-Toeplitz weight packing was
// an MXU-filling artefact and is not used. PERF.md records the other row
// counts, warp counts and block counts measured against this design.
#include <algorithm>
#include <atomic>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kRows = 8;         // output pitch rows per warp
constexpr int kWarps = 8;        // 16 time positions each
constexpr int kBlocksPerSm = 2;  // persistent blocks
constexpr int kMaxDevices = 64;
constexpr int kTileT = 16 * kWarps;
constexpr int kHaloH = kRows + 6;
constexpr int kHaloT = kTileT + 6;
constexpr int kHalo = kHaloH * kHaloT;          // positions (uint4) per buffer
constexpr int kThreads = 32 * kWarps;
constexpr int kSteps = 4 * kHaloH;              // (input row, tap pair)
// an NCHW output tile in shared memory, [row][co][t] float, rows of
// kOutT = kTileT + 4 floats: the fragment writes of a warp (channels 2q,
// positions g) then fall in 32 distinct banks
constexpr int kOutT = kTileT + 4;

// input / output layouts (bindings.cpp conv7 maps the operator's arguments)
enum Conv7Io { kNhwc8Bf16 = 0, kNchwF32 = 1, kNchwBf16 = 2 };

struct Conv7Args {
  const void* x;
  const uint32_t* w;
  const float* bias;
  void* y;
  int cin, H, T, n_rows, n_times, n_tiles;
};

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16_1688(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
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

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

struct Tile {
  int b, h0, t0;
};

__device__ __forceinline__ Tile tile_at(const Conv7Args& a, int tile) {
  const int tt = tile % a.n_times;
  const int rest = tile / a.n_times;
  return {rest / a.n_rows, (rest % a.n_rows) * kRows, tt * kTileT};
}

// Stage one tile's halo into buf: position (r, j) holds the input at pitch
// row h0 - 3 + r and time t0 - 3 + j, both wrapped, as 8 bf16 channels.
template <int IN>
__device__ __forceinline__ void stage(const Conv7Args& a, int tile,
                                      uint4* buf) {
  const Tile tl = tile_at(a, tile);
  const long long plane = static_cast<long long>(a.H) * a.T;
  // at most one wrap per axis when both cover a halo (the usual case):
  // a compare and an add instead of two integer divisions per position
  const bool once = a.H >= kHaloH && a.T >= kHaloT;
  int r = threadIdx.x / kHaloT, j = threadIdx.x % kHaloT;
#pragma unroll 2
  for (int i = threadIdx.x; i < kHalo; i += kThreads) {
    int h = tl.h0 - 3 + r, t = tl.t0 - 3 + j;
    if (once) {
      h += h < 0 ? a.H : h >= a.H ? -a.H : 0;
      t += t < 0 ? a.T : t >= a.T ? -a.T : 0;
    } else {
      h = wrap(h, a.H);
      t = wrap(t, a.T);
    }
    r += kThreads / kHaloT;
    j += kThreads % kHaloT;
    if (j >= kHaloT) {
      j -= kHaloT;
      ++r;
    }
    const long long at = static_cast<long long>(h) * a.T + t;
    if constexpr (IN == kNhwc8Bf16) {
      cp_async16(smem_u32(buf + i),
                 static_cast<const uint4*>(a.x) + (tl.b * plane + at));
    } else {
      using In = typename std::conditional<IN == kNchwF32, float,
                                           __nv_bfloat16>::type;
      const In* src = static_cast<const In*>(a.x) +
                      (static_cast<long long>(tl.b) * a.cin * plane + at);
      float v[8];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        v[c] = c < a.cin ? akt_to_float(src[c * plane]) : 0.f;
      buf[i] = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                          pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
    }
  }
}

__device__ __forceinline__ float leaky(float v) {
  return v >= 0.f ? v : 0.01f * v;
}

// One warp's kRows x 16 outputs of a staged tile: bias, leaky ReLU, bf16;
// stored channels-last, or for an NCHW output into the shared tile outsm
// as the bf16-rounded float.
template <int OUT>
__device__ __forceinline__ void compute(const Conv7Args& a, int tile,
                                        const uint4* buf,
                                        const uint32_t (&bw)[7][4][2],
                                        float b0, float b1, float* outsm) {
  const Tile tl = tile_at(a, tile);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tw = tl.t0 + 16 * warp;
  if (tw >= a.T) return;  // warp-uniform: a ragged last tile
  // ldmatrix row addresses: lanes 8i..8i+7 give matrix i's rows, i.e.
  // positions 16 warp + (lane & 7) + 8 (i & 1), plus 1 for i >= 2 (the
  // pair's second tap); tap 6's fragment is matrices 0 and 1 alone.
  const int mi = lane >> 3;
  const int pos = 16 * warp + (lane & 7) + 8 * (mi & 1);
  const uint32_t base = smem_u32(buf);
  const uint32_t addr_pair = base + (pos + (mi >> 1)) * 16;
  const uint32_t addr_last = base + pos * 16;
  const auto load = [&](uint32_t (&f)[4], int s) {
    const int r = s >> 2, p = s & 3;
    const uint32_t at = (p < 3 ? addr_pair : addr_last) +
                        (r * kHaloT + 2 * p) * 16;
    if (p == 3)
      ldmatrix_x2(f, at);
    else
      ldmatrix_x4(f, at);
  };
  float acc[kRows][4];
#pragma unroll
  for (int h = 0; h < kRows; ++h)
    acc[h][0] = acc[h][1] = acc[h][2] = acc[h][3] = 0.f;
  uint32_t f[2][4];
  load(f[0], 0);
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int r = s >> 2, p = s & 3;
    if (s + 1 < kSteps) load(f[(s + 1) & 1], s + 1);
#pragma unroll
    for (int h = 0; h < kRows; ++h) {
      const int dh = r - h;
      if (dh < 0 || dh >= 7) continue;
      if (p == 3)
        mma_bf16_1688(acc[h], f[s & 1], bw[dh][3][0]);
      else
        mma_bf16_16816(acc[h], f[s & 1], bw[dh][p][0], bw[dh][p][1]);
    }
  }
  const int g = lane >> 2, q = lane & 3;
  const long long plane = static_cast<long long>(a.H) * a.T;
#pragma unroll
  for (int h = 0; h < kRows; ++h) {
    const int row = tl.h0 + h;
    if (row >= a.H) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = tw + g + 8 * half;
      if (t >= a.T) continue;
      __nv_bfloat162 o = __floats2bfloat162_rn(leaky(acc[h][2 * half] + b0),
                                               leaky(acc[h][2 * half + 1] + b1));
      if constexpr (OUT == kNhwc8Bf16) {
        static_cast<uint32_t*>(a.y)[(tl.b * plane +
                                     static_cast<long long>(row) * a.T + t) *
                                        4 +
                                    q] = *reinterpret_cast<uint32_t*>(&o);
      } else {
        float* y = outsm + (h * 8 + 2 * q) * kOutT + t - tl.t0;
        y[0] = __bfloat162float(o.x);
        y[kOutT] = __bfloat162float(o.y);
      }
    }
  }
}

// The shared NCHW output tile to y: each (row, channel) run of up to
// kTileT positions by consecutive lanes.
template <int OUT>
__device__ __forceinline__ void flush(const Conv7Args& a, int tile,
                                      const float* outsm) {
  using Out = typename std::conditional<OUT == kNchwF32, float,
                                        __nv_bfloat16>::type;
  const Tile tl = tile_at(a, tile);
  const long long plane = static_cast<long long>(a.H) * a.T;
  const int n = min(kTileT, a.T - tl.t0);
  for (int i = threadIdx.x; i < kRows * 8 * kTileT; i += kThreads) {
    const int run = i / kTileT, t = i - run * kTileT;  // run = h * 8 + co
    const int row = tl.h0 + run / 8;
    if (t >= n || row >= a.H) continue;
    static_cast<Out*>(a.y)[(tl.b * 8LL + run % 8) * plane +
                           static_cast<long long>(row) * a.T + tl.t0 + t] =
        akt_from_float<Out>(outsm[run * kOutT + t]);
  }
}

// Shared memory: two halo buffers, then an NCHW output's tile.
template <int OUT>
constexpr int kSmemBytes =
    2 * kHalo * 16 + (OUT == kNhwc8Bf16 ? 0 : kRows * 8 * kOutT * 4);

template <int IN, int OUT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    conv7_kernel(const Conv7Args a) {
  extern __shared__ uint4 smem[];  // two halo buffers, the output tile
  float* outsm = reinterpret_cast<float*>(smem + 2 * kHalo);
  int tile = blockIdx.x;
  if (tile >= a.n_tiles) return;
  stage<IN>(a, tile, smem);
  cp_async_commit();
  const int lane = threadIdx.x & 31;
  uint32_t bw[7][4][2];
#pragma unroll
  for (int dh = 0; dh < 7; ++dh)
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int half = 0; half < 2; ++half)  // tap 7 (p 3, half 1) is zero
        bw[dh][p][half] = p == 3 && half ? 0u
            : __ldg(a.w + ((dh * 4 + p) * 2 + half) * 32 + lane);
  const float b0 = __ldg(a.bias + 2 * (lane & 3));
  const float b1 = __ldg(a.bias + 2 * (lane & 3) + 1);
  for (int k = 0; tile < a.n_tiles; ++k, tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (next < a.n_tiles) stage<IN>(a, next, smem + ((k + 1) & 1) * kHalo);
    cp_async_commit();
    cp_async_wait_one();  // this tile's copies (the one before the last)
    __syncthreads();
    compute<OUT>(a, tile, smem + (k & 1) * kHalo, bw, b0, b1, outsm);
    __syncthreads();  // the buffer is refilled two tiles on
    if constexpr (OUT != kNhwc8Bf16) flush<OUT>(a, tile, outsm);
  }
}

template <int IN, int OUT>
int launch(const Conv7Args& a, cudaStream_t stream) {
  const auto kernel = conv7_kernel<IN, OUT>;
  // set up once per device: the shared-memory attribute (per context) and
  // the persistent grid, kBlocksPerSm blocks per SM; 0 until then
  static std::atomic<int> blocks[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return AKT_BAD_ARGS;
  int grid = blocks[dev].load(std::memory_order_relaxed);
  if (grid == 0) {
    int sms = 0;
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             kSmemBytes<OUT>)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return static_cast<int>(err);
    grid = kBlocksPerSm * sms;
    blocks[dev].store(grid, std::memory_order_relaxed);
  }
  kernel<<<std::min(grid, a.n_tiles), kThreads, kSmemBytes<OUT>, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int IN>
int launch_out(const Conv7Args& a, int out, cudaStream_t stream) {
  switch (out) {
    case kNhwc8Bf16: return launch<IN, kNhwc8Bf16>(a, stream);
    case kNchwF32: return launch<IN, kNchwF32>(a, stream);
    default: return launch<IN, kNchwBf16>(a, stream);
  }
}

// (nchw, AktDtype) -> Conv7Io; -1 where the kernel has no such layout
int io_mode(int nchw, int dtype) {
  if (!nchw) return dtype == AKT_BF16 ? kNhwc8Bf16 : -1;
  return dtype == AKT_F32 ? kNchwF32 : dtype == AKT_BF16 ? kNchwBf16 : -1;
}

}  // namespace

// x: (B, H, T, 8) bf16 channels-last (in_nchw 0, cin 8) or (B, cin, H, T)
// float32 / bf16 (in_nchw 1); y: (B, H, T, 8) bf16 (out_nchw 0) or
// (B, 8, H, T) float32 / bf16; w_packed 7168 bytes, bias 8 float32.
// A channels-last x 16-byte aligned.
extern "C" int akt_conv7(const void* x, int in_nchw, int in_dtype, int cin,
                         const void* w_packed, const float* bias, void* y,
                         int out_nchw, int out_dtype, int batch, int H, int T,
                         void* stream) {
  const int in = io_mode(in_nchw, in_dtype), out = io_mode(out_nchw, out_dtype);
  const int n_rows = (H + kRows - 1) / kRows;
  const int n_times = (T + kTileT - 1) / kTileT;
  if (in < 0 || out < 0 || batch < 1 || H < 3 || T < 3 || cin < 1 ||
      cin > 8 || (in == kNhwc8Bf16 && cin != 8) ||
      static_cast<long long>(batch) * n_rows * n_times > 0x7fffffff)
    return AKT_BAD_ARGS;
  const Conv7Args a{x, static_cast<const uint32_t*>(w_packed), bias, y, cin,
                    H, T, n_rows, n_times, batch * n_rows * n_times};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in) {
    case kNhwc8Bf16: return launch_out<kNhwc8Bf16>(a, out, s);
    case kNchwF32: return launch_out<kNchwF32>(a, out, s);
    default: return launch_out<kNchwBf16>(a, out, s);
  }
}
