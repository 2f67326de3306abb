// The port's kernels as PyTorch operators: torch.ops.akt.<name>.
//
// The kernels' sources (*.cu) keep their plain C launchers and include no
// PyTorch header, so nvcc builds them in seconds. This host-only file is
// the one translation unit that sees PyTorch: it defines one operator per
// launcher, with an explicit schema, and registers a CUDA implementation
// of each. An implementation takes the device guard, allocates its output
// with at::empty (kernels A and B write into their caller's tensor
// instead, marked `Tensor(a!)`: cqt_cuda's stream arena and feature
// tensor), launches on PyTorch's current stream (so a launch can be
// captured into a torch.cuda.CUDAGraph) and turns a launcher's non-zero
// return code into an error. No CPU implementation is registered: the
// Python wrappers in ops/ run a kernel's plain version for a CPU tensor
// before they reach an operator.
//
// Only the light headers are included (not torch/extension.h, which pulls
// in pybind11 and the whole C++ API), to keep this file's build short.
#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <cstdint>
#include <optional>
#include <vector>

// The launchers of csrc/*.cu (plain C; each returns 0 or an error code).
extern "C" {
const char* akt_error_string(int code);
int akt_cascade_pad(const void* in, int in_dtype, long long in_stride,
                    int head_in, int L_in, void* out, int out_dtype,
                    long long out_stride, int head_out, int L_out, int n_out,
                    int batch, const float* taps_host, void* stream);
int akt_octave_response(const void* x0, int x0_dtype, long long x0_stride,
                        const void* arena, int arena_dtype,
                        long long arena_stride, const long long* offsets,
                        const int* lengths, int n_oct, const int* starts,
                        int n_frames, const float* bank_hi,
                        const float* bank_lo, const float* scales, int bpo,
                        int n_fft, float* out, long long out_stride, int batch,
                        void* stream);
int akt_octave_response_stage(const void* buf, int in_dtype,
                              long long buf_stride, int length,
                              const int* starts, int n_frames,
                              const float* bank_hi, const float* bank_lo,
                              const float* scales, int bpo, int n_fft,
                              float* out, int stage, int batch, void* stream);
int akt_conv7(const void* x, int in_nchw, int in_dtype, int cin,
              const void* w_packed, const float* bias, void* y, int out_nchw,
              int out_dtype, int batch, int H, int T, void* stream);
int akt_pcconv(const float* x, const float* w, const float* bias,
               const float* scale, const float* shift, const float* skip,
               float* y, int cin, int cout, int batch, int H, int T,
               void* stream);
int akt_resconv7(const float* x, const float* w, const float* bias,
                 const float* scale, const float* shift, const float* skip,
                 float* y, int cin, int cout, int batch, int H, int T,
                 void* stream);
int akt_window_copy(const void* x, long long stride, int Lpad, int batch,
                    const int* starts, int t_pad, int tile_t, int win,
                    int chunk, int variant, int static_stride, float* out,
                    void* stream);
int akt_transpose_pad(const void* y, int dtype, long long stride, int B,
                      int L, int half, int lfull, int run_rows, int chunk,
                      int grid, void* out, void* stream);
int akt_launch_probe(const void* in, float* out, int grid_n, int repeats,
                     void* stream);
int akt_probe_primitive(int which, const void* in, float* out, void* stream);
}

namespace {

constexpr int kTaps = 49;  // cqt_decimate.cu kTaps

// dtype codes of csrc/common.cuh (AktDtype)
int dtype_code(c10::ScalarType t) {
  TORCH_CHECK(t == c10::ScalarType::Float || t == c10::ScalarType::BFloat16 ||
                  t == c10::ScalarType::Short,
              "akt: unsupported dtype ", t);
  return t == c10::ScalarType::Float ? 0
         : t == c10::ScalarType::BFloat16 ? 1
                                          : 2;
}

void* stream() { return c10::cuda::getCurrentCUDAStream().stream(); }

void check_rc(int rc, const char* what) {
  TORCH_CHECK(rc == 0, what, ": CUDA launch failed (", rc, "): ",
              akt_error_string(rc));
}

// Every tensor of a call on the first one's CUDA device: the dispatcher
// picks the CUDA implementation when any one argument is on a card.
void same_device(const at::Tensor& first,
                 std::initializer_list<const at::Tensor*> rest,
                 const char* what) {
  TORCH_CHECK(first.is_cuda(), what, ": expects CUDA tensors");
  for (const at::Tensor* t : rest)
    TORCH_CHECK(t->device() == first.device(), what,
                ": every tensor must be on ", first.device(), ", got ",
                t->device());
}

void cascade_pad(const at::Tensor& buf, int64_t head, int64_t L_in,
                 int64_t L_out, const at::Tensor& out,
                 c10::ArrayRef<double> taps) {
  same_device(buf, {&out}, "akt::cascade_pad");
  TORCH_CHECK(static_cast<int>(taps.size()) == kTaps,
              "akt::cascade_pad: ", kTaps, " taps, got ", taps.size());
  const c10::cuda::CUDAGuard guard(buf.device());
  const std::vector<float> t(taps.begin(), taps.end());
  check_rc(akt_cascade_pad(buf.data_ptr(), dtype_code(buf.scalar_type()),
                           buf.stride(0), head, L_in, out.data_ptr(),
                           dtype_code(out.scalar_type()), out.stride(0), head,
                           L_out, out.size(1), buf.size(0), t.data(),
                           stream()),
           "cascade_pad (kernel A)");
}

void octave_response(const at::Tensor& x0, const at::Tensor& arena,
                     c10::IntArrayRef offsets, c10::IntArrayRef lengths,
                     const at::Tensor& starts, const at::Tensor& bank_hi,
                     const at::Tensor& bank_lo, const at::Tensor& scales,
                     const at::Tensor& out) {
  same_device(x0, {&arena, &starts, &bank_hi, &bank_lo, &scales, &out},
              "akt::octave_response");
  const int64_t n_oct = starts.size(0);
  TORCH_CHECK(static_cast<int64_t>(offsets.size()) == n_oct &&
                  static_cast<int64_t>(lengths.size()) == n_oct,
              "akt::octave_response: one offset and length per octave");
  const c10::cuda::CUDAGuard guard(x0.device());
  const std::vector<long long> off(offsets.begin(), offsets.end());
  const std::vector<int> len(lengths.begin(), lengths.end());
  check_rc(akt_octave_response(
               x0.data_ptr(), dtype_code(x0.scalar_type()), x0.stride(0),
               arena.data_ptr(), dtype_code(arena.scalar_type()),
               arena.stride(0), off.data(), len.data(), n_oct,
               starts.data_ptr<int>(), starts.size(1),
               bank_hi.data_ptr<float>(), bank_lo.data_ptr<float>(),
               scales.data_ptr<float>(), scales.size(1), bank_hi.size(0) * 8,
               out.data_ptr<float>(), out.stride(0), out.size(0), stream()),
           "octave_response (kernel B)");
}

at::Tensor octave_response_stage(const at::Tensor& ypad,
                                 const at::Tensor& starts,
                                 const at::Tensor& bank_hi,
                                 const at::Tensor& bank_lo,
                                 const at::Tensor& scales, int64_t stage) {
  same_device(ypad, {&starts, &bank_hi, &bank_lo, &scales},
              "akt::octave_response_stage");
  const c10::cuda::CUDAGuard guard(ypad.device());
  const int64_t bpo = scales.size(0);
  at::Tensor out = at::empty({ypad.size(0), bpo, starts.size(0)},
                             ypad.options().dtype(at::kFloat));
  check_rc(akt_octave_response_stage(
               ypad.data_ptr(), dtype_code(ypad.scalar_type()),
               ypad.stride(0), ypad.size(1), starts.data_ptr<int>(),
               starts.size(0), bank_hi.data_ptr<float>(),
               bank_lo.data_ptr<float>(), scales.data_ptr<float>(), bpo,
               bank_hi.size(0) * 8, out.data_ptr<float>(), stage,
               ypad.size(0), stream()),
           "octave_response_stage (kernel B)");
  return out;
}

// x channels-last (B, H, T, 8), or NCHW (B, cin, H, T) with nchw_in; the
// output channels-last bf16, or NCHW in nchw_out's dtype.
at::Tensor conv7(const at::Tensor& x, const at::Tensor& w_packed,
                 const at::Tensor& bias, bool nchw_in,
                 std::optional<c10::ScalarType> nchw_out) {
  same_device(x, {&w_packed, &bias}, "akt::conv7");
  TORCH_CHECK(x.dim() == 4, "akt::conv7: x must be 4-d, got ", x.sizes());
  const c10::cuda::CUDAGuard guard(x.device());
  const int64_t B = x.size(0), cin = nchw_in ? x.size(1) : x.size(3);
  const int64_t H = nchw_in ? x.size(2) : x.size(1);
  const int64_t T = nchw_in ? x.size(3) : x.size(2);
  at::Tensor y =
      nchw_out ? at::empty({B, 8, H, T}, x.options().dtype(*nchw_out))
               : at::empty({B, H, T, 8}, x.options().dtype(at::kBFloat16));
  check_rc(akt_conv7(x.data_ptr(), nchw_in, dtype_code(x.scalar_type()), cin,
                     w_packed.data_ptr(), bias.data_ptr<float>(),
                     y.data_ptr(), nchw_out.has_value(),
                     dtype_code(y.scalar_type()), B, H, T, stream()),
           "conv7_layer (kernel C)");
  return y;
}

// x (B, cin, H, T), w (cin, 7, 7, cout); the output (B, cout, H, T), all
// float32 NCHW; skip (B, cout, H, T) for a block's second conv.
at::Tensor resconv7(const at::Tensor& x, const at::Tensor& w,
                    const at::Tensor& bias, const at::Tensor& scale,
                    const at::Tensor& shift,
                    const std::optional<at::Tensor>& skip) {
  same_device(x, {&w, &bias, &scale, &shift}, "akt::resconv7");
  if (skip) same_device(x, {&*skip}, "akt::resconv7");
  TORCH_CHECK(x.dim() == 4 && w.dim() == 4,
              "akt::resconv7: x and w must be 4-d, got ", x.sizes(), ", ",
              w.sizes());
  const c10::cuda::CUDAGuard guard(x.device());
  at::Tensor y = at::empty({x.size(0), w.size(3), x.size(2), x.size(3)},
                           x.options());
  check_rc(akt_resconv7(x.data_ptr<float>(), w.data_ptr<float>(),
                        bias.data_ptr<float>(), scale.data_ptr<float>(),
                        shift.data_ptr<float>(),
                        skip ? skip->data_ptr<float>() : nullptr,
                        y.data_ptr<float>(), x.size(1), w.size(3), x.size(0),
                        x.size(2), x.size(3), stream()),
           "resconv7 (residual stack conv)");
  return y;
}

// x (B, cin, 12, T), w (cin, 7, 12, cout); the output (B, cout, 12, T),
// all float32 NCHW; skip (B, cout, 12, T) for a residual block's second
// conv.
at::Tensor pcconv(const at::Tensor& x, const at::Tensor& w,
                  const at::Tensor& bias, const at::Tensor& scale,
                  const at::Tensor& shift,
                  const std::optional<at::Tensor>& skip) {
  same_device(x, {&w, &bias, &scale, &shift}, "akt::pcconv");
  if (skip) same_device(x, {&*skip}, "akt::pcconv");
  TORCH_CHECK(x.dim() == 4 && w.dim() == 4,
              "akt::pcconv: x and w must be 4-d, got ", x.sizes(), ", ",
              w.sizes());
  const c10::cuda::CUDAGuard guard(x.device());
  at::Tensor y = at::empty({x.size(0), w.size(3), x.size(2), x.size(3)},
                           x.options());
  check_rc(akt_pcconv(x.data_ptr<float>(), w.data_ptr<float>(),
                      bias.data_ptr<float>(), scale.data_ptr<float>(),
                      shift.data_ptr<float>(),
                      skip ? skip->data_ptr<float>() : nullptr,
                      y.data_ptr<float>(), x.size(1), w.size(3), x.size(0),
                      x.size(2), x.size(3), stream()),
           "pcconv (pitch-class stack conv)");
  return y;
}

at::Tensor window_copy(const at::Tensor& x, const at::Tensor& starts,
                       int64_t tile_t, int64_t win, int64_t chunk,
                       int64_t variant, int64_t static_stride) {
  same_device(x, {&starts}, "akt::window_copy");
  TORCH_CHECK(tile_t >= 1, "akt::window_copy: tile_t ", tile_t);
  const c10::cuda::CUDAGuard guard(x.device());
  const int64_t t_pad = starts.size(0);
  at::Tensor out = at::empty({t_pad / tile_t, tile_t, 1},
                             x.options().dtype(at::kFloat));
  check_rc(akt_window_copy(x.data_ptr(), x.stride(0), x.size(1), x.size(0),
                           starts.data_ptr<int>(), t_pad, tile_t, win, chunk,
                           variant, static_stride, out.data_ptr<float>(),
                           stream()),
           "window_copy");
  return out;
}

at::Tensor transpose_pad(const at::Tensor& y, int64_t half, int64_t lfull,
                         int64_t run_rows, int64_t chunk, int64_t grid) {
  same_device(y, {}, "akt::transpose_pad");
  const c10::cuda::CUDAGuard guard(y.device());
  at::Tensor out = at::empty({lfull, y.size(0)}, y.options());
  check_rc(akt_transpose_pad(y.data_ptr(), dtype_code(y.scalar_type()),
                             y.stride(0), y.size(0), y.size(1), half, lfull,
                             run_rows, chunk, grid, out.data_ptr(), stream()),
           "transpose_pad");
  return out;
}

at::Tensor launch_probe(const at::Tensor& x, int64_t grid_n,
                        int64_t repeats) {
  TORCH_CHECK(x.is_cuda() && grid_n >= 1 && repeats >= 1,
              "akt::launch_probe: CUDA input, grid_n >= 1, repeats >= 1");
  const c10::cuda::CUDAGuard guard(x.device());
  at::Tensor out = at::empty({grid_n, 8, 128}, x.options().dtype(at::kFloat));
  check_rc(akt_launch_probe(x.data_ptr(), out.data_ptr<float>(), grid_n,
                            repeats, stream()),
           "launch_probe");
  return out;
}

at::Tensor probe_primitive(const at::Tensor& x, int64_t which,
                           at::IntArrayRef out_shape) {
  same_device(x, {}, "akt::probe_primitive");
  const c10::cuda::CUDAGuard guard(x.device());
  at::Tensor out = at::empty(out_shape, x.options().dtype(at::kFloat));
  check_rc(akt_probe_primitive(which, x.data_ptr(), out.data_ptr<float>(),
                               stream()),
           "probe_primitive");
  return out;
}

}  // namespace

TORCH_LIBRARY(akt, m) {
  m.def("cascade_pad(Tensor buf, int head, int L_in, int L_out, "
        "Tensor(a!) out, float[] taps) -> ()");
  m.def("octave_response(Tensor x0, Tensor arena, int[] offsets, "
        "int[] lengths, Tensor starts, Tensor bank_hi, Tensor bank_lo, "
        "Tensor scales, Tensor(a!) out) -> ()");
  m.def("octave_response_stage(Tensor ypad, Tensor starts, Tensor bank_hi, "
        "Tensor bank_lo, Tensor scales, int stage) -> Tensor");
  m.def("conv7(Tensor x, Tensor w_packed, Tensor bias, bool nchw_in, "
        "ScalarType? nchw_out) -> Tensor");
  m.def("resconv7(Tensor x, Tensor w, Tensor bias, Tensor scale, "
        "Tensor shift, Tensor? skip) -> Tensor");
  m.def("pcconv(Tensor x, Tensor w, Tensor bias, Tensor scale, "
        "Tensor shift, Tensor? skip) -> Tensor");
  m.def("window_copy(Tensor x, Tensor starts, int tile_t, int win, "
        "int chunk, int variant, int static_stride) -> Tensor");
  m.def("transpose_pad(Tensor y, int half, int lfull, int run_rows, "
        "int chunk, int grid) -> Tensor");
  m.def("launch_probe(Tensor x, int grid_n, int repeats) -> Tensor");
  m.def("probe_primitive(Tensor x, int which, int[] out_shape) -> Tensor");
}

TORCH_LIBRARY_IMPL(akt, CUDA, m) {
  m.impl("cascade_pad", &cascade_pad);
  m.impl("octave_response", &octave_response);
  m.impl("octave_response_stage", &octave_response_stage);
  m.impl("conv7", &conv7);
  m.impl("resconv7", &resconv7);
  m.impl("pcconv", &pcconv);
  m.impl("window_copy", &window_copy);
  m.impl("transpose_pad", &transpose_pad);
  m.impl("launch_probe", &launch_probe);
  m.impl("probe_primitive", &probe_primitive);
}
