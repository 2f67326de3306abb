// Window-copy rate probe: how fast a block can stage the CQT's frame
// windows from device memory into shared memory, per copy pattern.
//
// Replaces scripts/probe_dma_rate.py::build (the TPU's window-DMA chain
// probe). The stream is the port's batch-major (B, Lpad) int16 buffer;
// a step is tile_t consecutive frames, and a block stages one step's
// windows of win = n_fft + 16 samples for a chunk of clips:
//   grid        no copies; write 1.0 (launch and block scheduling alone);
//   dma1        window 0 of the step only;
//   dma3        all tile_t windows, each at starts[t] / 16 * 16;
//   dma3_static all tile_t windows at (t * stride) / 16 * 16, an address
//               computed from the block index alone (no table read); the
//               TPU probe's stride 8816 is its 44.1 kHz hop rounded down
//               to 16, and the wrapper passes hop // 16 * 16;
//   dma3_big    one contiguous span of tile_t * win samples per clip at
//               min(starts[step * tile_t], Lpad - tile_t * win - 16),
//               rounded down to 16;
//   dma3_db     as dma3, but a block walks kDbSteps steps and issues the
//               next step's copies before it waits for this step's.
// Every copy is cp.async of 16 bytes (cache-global), so the block spends
// no registers on the data. The chunk-0 block writes, per step,
// out[step][i] = x[0][offset of window 0 + i] for i < tile_t (as the TPU
// kernel writes frames[0, :tile_t, 0]), or 1.0 for `grid`.
//
// What bounds it on the H100: device memory bandwidth, if enough copies
// are in flight; the per-block issue and wait latency if not. The copies
// a block holds in flight are bounded by its shared memory (the wrapper
// sizes the clip chunk), and the double-buffered variant shows how much
// of the wait overlaps the next issue.
#include "common.cuh"

namespace {

enum Variant {
  kGrid = 0, kDma1 = 1, kDma3 = 2, kDma3Static = 3, kDma3Big = 4, kDma3Db = 5
};

constexpr int kThreads = 256;
constexpr int kAlign = 16;          // the TPU's sublane alignment of starts
constexpr int kMaxTile = 8;         // tile_t <= the TPU's _TILE_T
constexpr int kDbSteps = 4;         // steps one dma3_db block walks

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

struct Geometry {
  const int16_t* x;
  long long stride;
  int Lpad, batch, tile_t, win, chunk, variant, static_stride;
  const int* starts;
};

// Issue the cp.asyncs of one step into one slot of shared memory.
__device__ void issue(const Geometry& g, int step, int c0, int nc,
                      int16_t* dst, long long* soff) {
  const int tid = threadIdx.x;
  const bool big = g.variant == kDma3Big;
  const int n_win = big || g.variant == kDma1 ? 1 : g.tile_t;
  if (tid < n_win) {
    const long long t = static_cast<long long>(step) * g.tile_t + tid;
    long long off;
    if (g.variant == kDma3Static)
      off = t * g.static_stride;
    else if (big)
      off = min(static_cast<long long>(g.starts[t]),
                static_cast<long long>(g.Lpad) - g.tile_t * g.win - kAlign);
    else
      off = g.starts[t];
    soff[tid] = off / kAlign * kAlign;
  }
  __syncthreads();
  const int span = big ? g.tile_t * g.win : g.win;  // samples per copy run
  const int vec = span / 8;
  const int total = n_win * nc * vec;
  for (int e = tid; e < total; e += kThreads) {
    const int k = e % vec, r = e / vec;
    const int c = r % nc, j = r / nc;
    cp_async16(dst + (static_cast<long long>(j) * g.chunk + c) * span + k * 8,
               g.x + (c0 + c) * g.stride + soff[j] + k * 8);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kThreads)
    window_copy_kernel(Geometry g, int grid_n, float* __restrict__ out) {
  extern __shared__ __align__(16) int16_t smem[];
  __shared__ long long soff[2][kMaxTile];
  const int tid = threadIdx.x;
  const bool writer = blockIdx.y == 0;
  if (g.variant == kGrid) {
    if (writer && tid < g.tile_t) out[blockIdx.x * g.tile_t + tid] = 1.f;
    return;
  }
  const int c0 = blockIdx.y * g.chunk;
  const int nc = min(g.chunk, g.batch - c0);
  const bool db = g.variant == kDma3Db;
  const int step0 = db ? blockIdx.x * kDbSteps : blockIdx.x;
  const int n_steps = db ? min(kDbSteps, grid_n - step0) : 1;
  const long long slot_elems =
      static_cast<long long>(g.tile_t) * g.chunk * g.win;
  issue(g, step0, c0, nc, smem, soff[0]);
  for (int s = 0; s < n_steps; ++s) {
    const int slot = s & 1;
    if (s + 1 < n_steps) {
      issue(g, step0 + s + 1, c0, nc, smem + (slot ^ 1) * slot_elems,
            soff[slot ^ 1]);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (writer && tid < g.tile_t)
      out[(step0 + s) * g.tile_t + tid] =
          static_cast<float>(smem[slot * slot_elems + tid]);
    __syncthreads();
  }
}

}  // namespace

extern "C" int akt_window_copy(const void* x, long long stride, int Lpad,
                               int batch, const int* starts, int t_pad,
                               int tile_t, int win, int chunk, int variant,
                               int static_stride, float* out, void* stream) {
  if (variant < kGrid || variant > kDma3Db || tile_t < 1 ||
      tile_t > kMaxTile || t_pad % tile_t != 0 || win % 8 != 0 ||
      win < tile_t || chunk < 1 || batch < 1 || stride % 8 != 0 ||
      (batch + chunk - 1) / chunk > 65535 ||
      (variant == kDma3Big && Lpad < tile_t * win + kAlign))
    return AKT_BAD_ARGS;
  const int grid_n = t_pad / tile_t;
  const int slots = variant == kDma3Db ? 2 : 1;
  const long long smem = 2LL * slots * tile_t * chunk * win;
  if (smem > 227 * 1024) return AKT_BAD_ARGS;
  const int bytes = variant == kGrid ? 0 : static_cast<int>(smem);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Geometry g{static_cast<const int16_t*>(x), stride, Lpad, batch,
                   tile_t, win, chunk, variant, static_stride, starts};
  const int gx = variant == kDma3Db ? (grid_n + kDbSteps - 1) / kDbSteps
                                    : grid_n;
  const dim3 grid(gx, (batch + chunk - 1) / chunk);
  window_copy_kernel<<<grid, kThreads, bytes,
                       static_cast<cudaStream_t>(stream)>>>(g, grid_n, out);
  return static_cast<int>(cudaGetLastError());
}
