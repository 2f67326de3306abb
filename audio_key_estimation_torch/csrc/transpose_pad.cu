// Transpose-pad: (B, L) batch-major clips -> (lfull, B) time-major stream,
// reflect-padded by librosa's centered-frame pad and zero-extended.
//
// Replaces scripts/experiment_transpose_kernel.py::_transpose_pad_call.
// Computes, for output row r and clip b (half = n_fft // 2),
//   out[r][b] = y[b][half - r]              r < half        (reflect head)
//             = y[b][r - half]              r < half + L    (the signal)
//             = y[b][2L + half - 2 - r]     r < 2*half + L + 1 (reflect tail)
//             = 0                           beyond, up to lfull
// exactly, for int16 and float32 (a copy; no arithmetic touches a value).
// The TPU kernel transposed on the MXU against an identity, carrying each
// value as a bf16 hi/lo pair to stay exact; that was an MXU artefact and
// has no counterpart here.
//
// What bounds it on the H100: device memory bandwidth, each sample read
// once and written once. Design (ops/probes_cuda.py::transpose_plan sizes
// it; the wrapper passes run_rows, chunk and grid):
//   * work item = a run of run_rows output rows for a chunk of <= 32
//     clips; a persistent grid (a few blocks per SM, as shared memory
//     allows) walks the items, two stages of shared memory per block;
//   * loads: the sources of a run's rows are one span of at most run_rows
//     samples per clip (r -> source is 1-Lipschitz). Lanes of warp 0 each
//     issue one bulk copy (cp.async.bulk, the copy engine) of its clip's
//     span, widened to 16-byte boundaries and clamped to the tensor's
//     bytes; the few bytes a clamp cuts are copied by the lane, before
//     lane 0 arrives on the stage's mbarrier with the stage's byte count,
//     which every copy of the stage then completes. One path for
//     any row stride: each clip's span keeps its own offset in its slot;
//   * item i+1's copies are issued before item i is transposed;
//   * transpose: in interior runs (every row a signal row) whose chunk is
//     a power of two, each thread owns fixed clips and row offsets, reads
//     its 16 bytes of output from the slots (offsets computed once per
//     run) and writes them with one 16-byte store; consecutive threads
//     write consecutive 16-byte pieces (a B <= 32 run is one contiguous
//     region). Slots are run bytes + 128 apart and shifted by 16-byte
//     multiples so that the clips one warp reads at once fall in distinct
//     banks. Edge runs (reflect head, tail, zero rows, the last partial
//     run) and chunks of other sizes take a per-element path from the
//     same staged spans.
// Measured and dropped: the first design, 32 x 32 shared tiles of scalar
// loads and 2-byte stores in blocks of 8 KB, ran at 24% of the byte bound
// (PERF.md section 6). A bulk store of the output from shared memory was
// not taken: it needs a second buffer per stage, and direct 16-byte
// stores already write whole sectors.
#include "common.cuh"

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 256;
constexpr int kMaxChunk = 32;  // clips a work item stages (lanes of warp 0)
constexpr int kSlotPad = 128;  // a slot's bytes beyond the run: 16-byte
                               // widening plus a bank shift of <= 112

__device__ __forceinline__ long long source_row(long long r, long long L,
                                                long long half) {
  if (r < half) return half - r;
  if (r < half + L) return r - half;
  if (r < 2 * half + L + 1) return 2 * L + half - 2 - r;
  return -1;
}

struct Args {
  const char* y;      // element (0, 0)
  const char* y_end;  // one past the last clip's last element
  char* out;
  long long stride;   // elements between clips
  long long lfull;
  int B, L, half;
  int run_rows, chunk, n_chunks, row_bytes;
  long long n_runs;
};

// One work item's geometry, the same in every thread.
struct Item {
  long long r0, s_lo;  // first output row, first staged source sample
  int nr, b0, nb;      // rows (<= run_rows), first clip, clips
  int span;            // staged samples per clip (0: zero rows only)
  bool interior;       // every row a signal row, run_rows of them
};

__device__ __forceinline__ Item item_of(const Args& a, long long w) {
  Item it;
  const long long run = w / a.n_chunks;
  it.b0 = static_cast<int>(w - run * a.n_chunks) * a.chunk;
  it.nb = min(a.chunk, a.B - it.b0);
  it.r0 = run * a.run_rows;
  it.nr = static_cast<int>(min(static_cast<long long>(a.run_rows),
                               a.lfull - it.r0));
  const long long half = a.half, L = a.L;
  // rows with a source: [r0, min(r0 + nr, 2 half + L + 1)); their
  // sources form one interval (the row -> source map moves by 1 a row)
  const long long last = min(it.r0 + it.nr, 2 * half + L + 1) - 1;
  it.interior = it.r0 >= half && it.r0 + a.run_rows <= half + L &&
                it.nr == a.run_rows;
  if (last < it.r0) {
    it.s_lo = 0;
    it.span = 0;
    return it;
  }
  const long long s0 = source_row(it.r0, L, half);
  const long long s1 = source_row(last, L, half);
  long long lo = min(s0, s1), hi = max(s0, s1);
  if (it.r0 <= half && half <= last) lo = 0;
  if (it.r0 <= half + L - 1 && half + L - 1 <= last) hi = L - 1;
  it.s_lo = lo;
  it.span = static_cast<int>(hi - lo + 1);
  return it;
}

// A clip's slot in a stage: row_bytes apart (a multiple of 128), shifted
// by 16-byte multiples so that the clips a warp's lanes read together
// (j, j + E, j + 2E, ... for E elements of 16 bytes) start in different
// banks: a group of E clips moves the slot by 128 * E / chunk' bytes
// (chunk' the chunk rounded up to a power of two), mod 128.
template <typename T>
__device__ __forceinline__ int slot_of(const Args& a, int j) {
  constexpr int E = 16 / sizeof(T);
  int cp = 1;
  while (cp < a.chunk) cp <<= 1;
  const int shift = ((j / E) * (128 * E / cp)) & (kSlotPad - 16);
  return j * a.row_bytes + shift;
}

// Byte offset, inside its 16-byte line, of clip j's first staged sample.
template <typename T>
__device__ __forceinline__ int misalign(const Args& a, const Item& it,
                                        int j) {
  const char* p =
      a.y + ((it.b0 + j) * a.stride + it.s_lo) * static_cast<long long>(
                                                     sizeof(T));
  return static_cast<int>(reinterpret_cast<u64>(p) & 15);
}

// Warp 0: stage item `it` into `stage`, completing on `bar`.
template <typename T>
__device__ void issue(const Args& a, const Item& it, char* stage,
                      uint64_t* bar) {
  const int lane = threadIdx.x;
  const u64 begin = (reinterpret_cast<u64>(a.y) + 15) & ~15ull;
  const u64 end = reinterpret_cast<u64>(a.y_end) & ~15ull;
  u64 p = 0, lo = 0, clo = 0, chi = 0, n = 0;
  uint32_t bytes = 0;
  if (lane < it.nb && it.span > 0) {
    p = reinterpret_cast<u64>(a.y) +
        ((it.b0 + lane) * a.stride + it.s_lo) * sizeof(T);
    n = static_cast<u64>(it.span) * sizeof(T);
    lo = p & ~15ull;
    const u64 hi = (p + n + 15) & ~15ull;
    clo = max(lo, begin);
    chi = min(hi, end);
    if (chi > clo) {
      bytes = static_cast<uint32_t>(chi - clo);
    } else {
      clo = chi = p + n;  // too short to widen inside the tensor
    }
  }
  char* slot = stage + slot_of<T>(a, lane);
  if (lane < it.nb && it.span > 0) {
    // the samples a clamp cut off the bulk copy (< 16 bytes each end)
    for (u64 q = p; q < min(clo, p + n); q += sizeof(T))
      *reinterpret_cast<T*>(slot + (q - lo)) =
          *reinterpret_cast<const T*>(q);
    for (u64 q = max(chi, p); q < p + n; q += sizeof(T))
      *reinterpret_cast<T*>(slot + (q - lo)) =
          *reinterpret_cast<const T*>(q);
  }
  const uint32_t total = __reduce_add_sync(0xffffffffu, bytes);
  // the lanes' stores above come before the arrival, which releases them
  // to the waiters: the phase may complete at once (total 0)
  __syncwarp();
  if (lane == 0) akt_mbar_arrive_expect_tx(bar, total);
  __syncwarp();
  if (bytes) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    akt_bulk_load(slot + (clo - lo), reinterpret_cast<const void*>(clo),
                  bytes, bar);
  }
}

__device__ __forceinline__ void store16(char* dst, const float (&v)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store16(char* dst, const int16_t (&v)[8]) {
  uint4 u;
  u.x = __byte_perm(v[0], v[1], 0x5410);
  u.y = __byte_perm(v[2], v[3], 0x5410);
  u.z = __byte_perm(v[4], v[5], 0x5410);
  u.w = __byte_perm(v[6], v[7], 0x5410);
  *reinterpret_cast<uint4*>(dst) = u;
}

// Write item `it`'s output rows from its staged spans.
template <typename T>
__device__ void emit(const Args& a, const Item& it, const char* stage) {
  constexpr int E = 16 / sizeof(T);
  const int tid = threadIdx.x;
  const int nb = it.nb;
  // 16-byte pieces land on 16-byte boundaries: a B <= 32 run is one
  // contiguous region, else each row's piece of the chunk must be
  const bool vec = nb == a.B || ((a.B * static_cast<int>(sizeof(T))) % 16 ==
                                     0 &&
                                 (a.chunk * static_cast<int>(sizeof(T))) % 16 ==
                                     0 &&
                                 nb % E == 0);
  if (it.interior && vec && (nb & (nb - 1)) == 0) {
    // thread tid owns the 16-byte pieces q = tid + n * kThreads of the
    // item's (run_rows, nb) tile; its clips and row offsets are fixed,
    // and each sweep of the block moves on kThreads * E / nb rows
    const int sweep_rows = kThreads * E / nb;
    int off[E];
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int e = tid * E + k;
      const int j = e & (nb - 1), r = e / nb;
      // interior: row r0 + r reads sample s_lo + r
      off[k] = slot_of<T>(a, j) + misalign<T>(a, it, j) + r * sizeof(T);
    }
    const int e0 = tid * E;
    char* o = a.out + ((it.r0 + e0 / nb) * a.B + it.b0 + (e0 & (nb - 1))) *
                          static_cast<long long>(sizeof(T));
    const long long o_step =
        static_cast<long long>(sweep_rows) * a.B * sizeof(T);
    const int in_step = sweep_rows * sizeof(T);
    const int nq = a.run_rows * nb / E;
    for (int q = tid, n = 0; q < nq; q += kThreads, ++n) {
      T v[E];
#pragma unroll
      for (int k = 0; k < E; ++k)
        v[k] = *reinterpret_cast<const T*>(stage + off[k] + n * in_step);
      store16(o + n * o_step, v);
    }
    return;
  }
  T* out = reinterpret_cast<T*>(a.out);
  const int n = it.nr * nb;
  for (int e = tid; e < n; e += kThreads) {
    const int r = e / nb, j = e - r * nb;
    const long long row = it.r0 + r;
    const long long src = source_row(row, a.L, a.half);
    T v = T(0);
    if (src >= 0)
      v = *reinterpret_cast<const T*>(stage + slot_of<T>(a, j) +
                                      misalign<T>(a, it, j) +
                                      (src - it.s_lo) * sizeof(T));
    out[row * a.B + it.b0 + j] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    transpose_pad_kernel(Args a) {
  extern __shared__ __align__(128) char smem[];
  __shared__ uint64_t bars[2];
  const long long n_work = a.n_runs * a.n_chunks;
  long long w = blockIdx.x;
  if (w >= n_work) return;  // uniform across the block
  const int stage_bytes = a.chunk * a.row_bytes;
  if (threadIdx.x == 0) {
    akt_mbar_init(&bars[0]);
    akt_mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  Item cur = item_of(a, w);
  if (threadIdx.x < 32) issue<T>(a, cur, smem, &bars[0]);
  for (int i = 0; w < n_work; ++i) {
    const int s = i & 1;
    const long long wn = w + gridDim.x;
    Item next = cur;
    if (wn < n_work) {
      next = item_of(a, wn);
      // stage s ^ 1 was last read in step i - 1, before its barrier
      if (threadIdx.x < 32)
        issue<T>(a, next, smem + (s ^ 1) * stage_bytes, &bars[s ^ 1]);
    }
    akt_mbar_wait(&bars[s], (i >> 1) & 1);
    emit<T>(a, cur, smem + s * stage_bytes);
    __syncthreads();
    w = wn;
    cur = next;
  }
}

template <typename T>
int launch(const Args& a, int grid, cudaStream_t s) {
  const int bytes = 2 * a.chunk * a.row_bytes;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        transpose_pad_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  transpose_pad_kernel<T><<<grid, kThreads, bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int akt_transpose_pad(const void* y, int dtype, long long stride,
                                 int B, int L, int half, int lfull,
                                 int run_rows, int chunk, int grid, void* out,
                                 void* stream) {
  const int item = dtype == AKT_F32 ? 4 : dtype == AKT_I16 ? 2 : 0;
  // one reflection each side: the wrapper refuses L < half + 2
  if (item == 0 || B < 1 || L < half + 2 || half < 1 || lfull < 1 ||
      chunk < 1 || chunk > kMaxChunk || run_rows < 1 ||
      run_rows * item % kSlotPad != 0 || grid < 1 ||
      reinterpret_cast<u64>(out) % 16 != 0)
    return AKT_BAD_ARGS;
  Args a;
  a.y = static_cast<const char*>(y);
  a.y_end = a.y + ((B - 1) * stride + L) * static_cast<long long>(item);
  a.out = static_cast<char*>(out);
  a.stride = stride;
  a.lfull = lfull;
  a.B = B;
  a.L = L;
  a.half = half;
  a.run_rows = run_rows;
  a.chunk = chunk;
  a.n_chunks = (B + chunk - 1) / chunk;
  a.row_bytes = run_rows * item + kSlotPad;
  a.n_runs = (lfull + run_rows - 1) / static_cast<long long>(run_rows);
  if (2LL * chunk * a.row_bytes > 227 * 1024) return AKT_BAD_ARGS;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == AKT_F32 ? launch<float>(a, grid, s)
                          : launch<int16_t>(a, grid, s);
}
