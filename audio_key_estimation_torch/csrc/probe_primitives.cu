// Primitive probes: six tiny kernels, one per TPU lowering probe, each
// producing exactly the array its probe expects.
//
// Replaces scripts/probe_pallas_primitives.py::p1_reshape, p2_strided,
// p3_int16, p4_dma, p4b_dma_2d and p5_window. On the TPU each asked
// whether Mosaic lowers a primitive (value reshape, strided sublane
// slice, int16 load, DMA at a dynamic offset, lane-slice concat); on
// Hopper each is index arithmetic, so each kernel is a gather whose
// output the probe's numpy reference pins:
//   0 p1_reshape  (8, 128) f32 -> (4, 256), row-major reshape
//   1 p2_strided  (8, 128) f32 -> (4, 256) = [x[0::2] | x[1::2]]
//   2 p3_int16    (8, 128) i16 -> (8, 128) f32, x / 32768
//   3 p4_dma      (4, 4096) f32 -> (4, 256), row i from i*128+64, x 2
//   4 p4b_dma_2d  (64, 256) f32 -> (4, 16, 256), rows i*8+3.., + 1
//   5 p5_window   (9, 256) f32 -> (8, 304) = [x[:8] | x[1:9, :48]]
// What bounds them: launch latency; a few KB each. One block per output
// tile of at most 4096 elements, 256 threads.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    primitive_kernel(int which, const void* __restrict__ in,
                     float* __restrict__ out) {
  const float* x = static_cast<const float*>(in);
  const int i = blockIdx.x;  // the TPU probe's grid index (p4, p4b)
  switch (which) {
    case 0:
      for (int e = threadIdx.x; e < 4 * 256; e += kThreads) {
        const int r = e / 256, c = e % 256;
        out[e] = x[(2 * r + c / 128) * 128 + c % 128];
      }
      break;
    case 1:
      for (int e = threadIdx.x; e < 4 * 256; e += kThreads) {
        const int r = e / 256, c = e % 256;
        out[e] = c < 128 ? x[(2 * r) * 128 + c] : x[(2 * r + 1) * 128 + c - 128];
      }
      break;
    case 2: {
      const int16_t* x16 = static_cast<const int16_t*>(in);
      for (int e = threadIdx.x; e < 8 * 128; e += kThreads)
        out[e] = static_cast<float>(x16[e]) * (1.0f / 32768.0f);
      break;
    }
    case 3:
      for (int k = threadIdx.x; k < 256; k += kThreads)
        out[i * 256 + k] = x[i * 4096 + i * 128 + 64 + k] * 2.0f;
      break;
    case 4:
      for (int e = threadIdx.x; e < 16 * 256; e += kThreads) {
        const int r = e / 256, c = e % 256;
        out[i * 16 * 256 + e] = x[(i * 8 + 3 + r) * 256 + c] + 1.0f;
      }
      break;
    case 5:
      for (int e = threadIdx.x; e < 8 * 304; e += kThreads) {
        const int r = e / 304, c = e % 304;
        out[e] = c < 256 ? x[r * 256 + c] : x[(r + 1) * 256 + c - 256];
      }
      break;
  }
}

}  // namespace

extern "C" int akt_probe_primitive(int which, const void* in, float* out,
                                   void* stream) {
  if (which < 0 || which > 5) return AKT_BAD_ARGS;
  const int blocks = which == 3 || which == 4 ? 4 : 1;
  primitive_kernel<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(which, in, out);
  return static_cast<int>(cudaGetLastError());
}
