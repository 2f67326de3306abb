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
// What bounds it on the H100: device memory bandwidth (each sample read
// once, written once). Design: the classic tiled transpose, 32 x 32
// tiles staged in shared memory with a padded stride, reads coalesced
// along time, writes coalesced along the batch; a block walks kSteps
// tiles down the time axis, so a small batch still gives each block a
// few KB. For B <= 32 the block's output rows are one contiguous run, and
// it writes them linearly (the serving batch of 16 clips would otherwise
// store 32-byte rows from half-idle warps). The pad rows read the input
// directly through the same index map.
#include "common.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;   // threadIdx.y; each thread moves kTile / kRows
constexpr int kSteps = 4;  // 32-row tiles per block along time

__device__ __forceinline__ long long source_row(long long r, int L, int half) {
  if (r < half) return half - r;
  if (r < half + static_cast<long long>(L)) return r - half;
  if (r < 2LL * half + L + 1) return 2LL * L + half - 2 - r;
  return -1;
}

template <typename T>
__global__ void __launch_bounds__(kTile * kRows) transpose_pad_kernel(
    const T* __restrict__ y, long long stride, int B, int L, int half,
    int lfull, T* __restrict__ out) {
  __shared__ T tile[kTile][kTile + 1];
  const int b0 = blockIdx.y * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  for (int step = 0; step < kSteps; ++step) {
    const long long r0 =
        (static_cast<long long>(blockIdx.x) * kSteps + step) * kTile;
    if (r0 >= lfull) return;  // uniform across the block
    const long long r = r0 + tx;
    const long long src = r < lfull ? source_row(r, L, half) : -1;
    for (int j = ty; j < kTile; j += kRows) {
      const int b = b0 + j;
      tile[j][tx] = (b < B && src >= 0) ? y[b * stride + src] : T(0);
    }
    __syncthreads();
    if (B <= kTile) {
      // rows r0 .. r0+31 of a (lfull, B) array are contiguous
      for (int e = tid; e < kTile * B; e += kTile * kRows) {
        const long long ro = r0 + e / B;
        if (ro < lfull) out[r0 * B + e] = tile[e % B][e / B];
      }
    } else {
      for (int j = ty; j < kTile; j += kRows) {
        const long long ro = r0 + j;
        const int b = b0 + tx;
        if (ro < lfull && b < B) out[ro * B + b] = tile[tx][j];
      }
    }
    __syncthreads();
  }
}

template <typename T>
void launch(const void* y, long long stride, int B, int L, int half,
            int lfull, void* out, cudaStream_t s) {
  const int rows_per_block = kTile * kSteps;
  const dim3 grid((lfull + rows_per_block - 1) / rows_per_block,
                  (B + kTile - 1) / kTile);
  transpose_pad_kernel<T><<<grid, dim3(kTile, kRows), 0, s>>>(
      static_cast<const T*>(y), stride, B, L, half, lfull,
      static_cast<T*>(out));
}

}  // namespace

extern "C" int akt_transpose_pad(const void* y, int dtype, long long stride,
                                 int B, int L, int half, int lfull, void* out,
                                 void* stream) {
  // one reflection each side: the wrapper refuses L < half + 2
  if (B < 1 || (B + kTile - 1) / kTile > 65535 || L < half + 2 ||
      half < 1 || lfull < 1)
    return AKT_BAD_ARGS;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case AKT_F32: launch<float>(y, stride, B, L, half, lfull, out, s); break;
    case AKT_I16: launch<int16_t>(y, stride, B, L, half, lfull, out, s); break;
    default: return AKT_BAD_ARGS;
  }
  return static_cast<int>(cudaGetLastError());
}
