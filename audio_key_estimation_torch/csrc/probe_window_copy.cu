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
//   dma3_db     as dma3, but a block walks kDbSteps steps through two
//               slots, each with its own mbarrier, and issues the next
//               step's copies before it waits for this step's.
// The chunk-0 block writes, per step, out[step][i] = x[0][offset of
// window 0 + i] for i < tile_t (as the TPU kernel writes
// frames[0, :tile_t, 0]), or 1.0 for `grid`.
//
// Each window (dma3, dma3_static, dma3_db), or each clip's one window
// (dma1) or span (dma3_big), is one bulk copy (cp.async.bulk: the copy
// engine, as the TPU probe issued one descriptor DMA per window), issued
// by the lanes of the block's one warp; a step's copies complete on one
// mbarrier that expects their byte total, and the warp waits on its
// phase. The copies hold no registers and take no per-16-byte
// instruction. What bounds it on the H100: device memory bandwidth, once
// enough copies are in flight, and the launch floor (~1.7 us a launch
// from a CUDA graph, PERF.md section 6, #8) for six launches of a few
// microseconds each. The wrapper (ops/probes_cuda.py::window_plan) picks
// the fewest clip chunks that give the grid at least two blocks per SM;
// block row y stages clips [y B / n, (y + 1) B / n) of the n chunks.
// Measured and dropped: the first design, 256 threads each issuing
// 16-byte cp.async, ran at 32% of the summed byte bound from a CUDA graph.
#include "common.cuh"

namespace {

enum Variant {
  kGrid = 0, kDma1 = 1, kDma3 = 2, kDma3Static = 3, kDma3Big = 4, kDma3Db = 5
};

constexpr int kGridThreads = 256;   // `grid`: as the first design launched
constexpr int kCopyThreads = 32;    // the copy variants: one warp
constexpr int kAlign = 16;          // the TPU's sublane alignment of starts
constexpr int kMaxTile = 8;         // tile_t <= the TPU's _TILE_T
constexpr int kDbSteps = 4;         // steps one dma3_db block walks

struct Geometry {
  const int16_t* x;
  long long stride;
  int Lpad, batch, tile_t, win, chunk, variant, static_stride;
  const int* starts;
  int n_win, span;      // copies per clip and step, samples per copy
  long long slot_elems;  // one step's staged samples: n_win * chunk * span
};

// The warp issues one step's bulk copies into one slot, completing on bar.
__device__ void issue(const Geometry& g, int step, int c0, int nc,
                      int16_t* dst, long long* soff, uint64_t* bar) {
  const int lane = threadIdx.x;
  const bool big = g.variant == kDma3Big;
  // lagging lanes may still read soff in the previous step's copy loop
  __syncwarp();
  const int n_win = g.n_win, span = g.span;
  if (lane < n_win) {
    const long long t = static_cast<long long>(step) * g.tile_t + lane;
    long long off;
    if (g.variant == kDma3Static)
      off = t * g.static_stride;
    else if (big)
      off = min(static_cast<long long>(g.starts[t]),
                static_cast<long long>(g.Lpad) - g.tile_t * g.win - kAlign);
    else
      off = g.starts[t];
    soff[lane] = off / kAlign * kAlign;
  }
  const uint32_t bytes = static_cast<uint32_t>(span) * 2;
  const int n_copies = n_win * nc;
  __syncwarp();
  if (lane == 0) akt_mbar_arrive_expect_tx(bar, bytes * n_copies);
  __syncwarp();
  // the slot was last read (generic proxy) before the caller's __syncwarp
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  for (int i = lane; i < n_copies; i += kCopyThreads) {
    const int j = i / nc, c = i - j * nc;
    akt_bulk_load(dst + (static_cast<long long>(j) * g.chunk + c) * span,
                  g.x + (c0 + c) * g.stride + soff[j], bytes, bar);
  }
}

__global__ void __launch_bounds__(kGridThreads)
    window_copy_kernel(Geometry g, int grid_n, float* __restrict__ out) {
  extern __shared__ __align__(128) int16_t smem[];
  __shared__ uint64_t bars[2];
  __shared__ long long soff[kMaxTile];
  const int tid = threadIdx.x;
  const bool writer = blockIdx.y == 0;
  if (g.variant == kGrid) {
    if (writer && tid < g.tile_t) out[blockIdx.x * g.tile_t + tid] = 1.f;
    return;
  }
  // gridDim.y even chunks of floor or ceil(batch / gridDim.y) <= chunk
  const int c0 = blockIdx.y * g.batch / gridDim.y;
  const int nc = (blockIdx.y + 1) * g.batch / gridDim.y - c0;
  const bool db = g.variant == kDma3Db;
  const int step0 = db ? blockIdx.x * kDbSteps : blockIdx.x;
  const int n_steps = db ? min(kDbSteps, grid_n - step0) : 1;
  const long long slot_elems = g.slot_elems;
  if (tid == 0) {
    akt_mbar_init(&bars[0]);
    akt_mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  issue(g, step0, c0, nc, smem, soff, &bars[0]);
  for (int s = 0; s < n_steps; ++s) {
    const int slot = s & 1;
    if (s + 1 < n_steps)
      issue(g, step0 + s + 1, c0, nc, smem + (slot ^ 1) * slot_elems, soff,
            &bars[slot ^ 1]);
    // every block waits for its copies, the writer or not: none exits
    // with copies in flight
    akt_mbar_wait(&bars[slot], (s >> 1) & 1);
    if (writer && tid < g.tile_t)
      out[(step0 + s) * g.tile_t + tid] =
          static_cast<float>(smem[slot * slot_elems + tid]);
    __syncwarp();
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
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      (batch + chunk - 1) / chunk > 65535 ||
      (variant == kDma3Big && Lpad < tile_t * win + kAlign))
    return AKT_BAD_ARGS;
  const int grid_n = t_pad / tile_t;
  const int slots = variant == kDma3Db ? 2 : 1;
  const bool one = variant == kDma1 || variant == kDma3Big;
  const int n_win = one ? 1 : tile_t;
  const int span = variant == kDma3Big ? tile_t * win : win;
  const long long slot_elems = static_cast<long long>(n_win) * chunk * span;
  const long long smem = 2LL * slots * slot_elems;
  if (smem > 227 * 1024) return AKT_BAD_ARGS;
  const int bytes = variant == kGrid ? 0 : static_cast<int>(smem);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Geometry g{static_cast<const int16_t*>(x), stride, Lpad, batch,
                   tile_t, win, chunk, variant, static_stride, starts,
                   n_win, span, slot_elems};
  const int gx = variant == kDma3Db ? (grid_n + kDbSteps - 1) / kDbSteps
                                    : grid_n;
  const dim3 grid(gx, (batch + chunk - 1) / chunk);
  const int threads = variant == kGrid ? kGridThreads : kCopyThreads;
  window_copy_kernel<<<grid, threads, bytes,
                       static_cast<cudaStream_t>(stream)>>>(g, grid_n, out);
  return static_cast<int>(cudaGetLastError());
}
