// Launch-overhead probe: a kernel whose grid_n blocks each write 1.0 into
// one (8, 128) float32 tile of out and never read their input.
//
// Replaces scripts/probe_pallas_overhead.py::build (the TPU's empty-body
// grid probe). Timed over a matrix of (input bytes x grid_n), it separates
// a cost per launch (flat in both), per block (grows with grid_n) and per
// input byte (grows with the untouched input, which it must not).
//
// What bounds it on the H100: nothing but the launch itself and block
// scheduling; 4 KB written per block. One block of 1024 threads per tile,
// one store per thread.
#include "common.cuh"

namespace {

constexpr int kTile = 8 * 128;

__global__ void __launch_bounds__(kTile)
    launch_probe_kernel(const void* /*untouched input*/,
                        float* __restrict__ out) {
  out[static_cast<long long>(blockIdx.x) * kTile + threadIdx.x] = 1.f;
}

}  // namespace

extern "C" int akt_launch_probe(const void* in, float* out, int grid_n,
                                int repeats, void* stream) {
  if (grid_n < 1 || repeats < 1) return AKT_BAD_ARGS;
  for (int i = 0; i < repeats; ++i) {
    launch_probe_kernel<<<grid_n, kTile, 0,
                          static_cast<cudaStream_t>(stream)>>>(in, out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
