"""PyTorch port: the CQT front-end against the JAX package, on the CPU.

Kernels A and B (ops/cqt_cuda.py) run their plain PyTorch versions here
(CPU tensors); the CUDA kernels themselves are held against those plain
versions on the card by chip_smoke.py. Inputs come from a numpy seed and
are cast to float32 explicitly (conftest turns on jax_enable_x64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_key_estimation_tpu.ops import cqt as jax_cqt
from audio_key_estimation_tpu.ops import cqt_pallas as jax_cqt_pallas
from audio_key_estimation_tpu.ops.frontend import compute_cqt as jax_compute_cqt

from audio_key_estimation_torch.ops import cqt, cqt_cuda
from audio_key_estimation_torch.ops.frontend import compute_cqt

SR = 22050
P_JAX = jax_cqt.CQTParams(sr=SR, hop=4410, bins_per_octave=36, octaves=8)
P = cqt.CQTParams(sr=SR, hop=4410, bins_per_octave=36, octaves=8)


def _signals(rng, batch, seconds):
    t = np.arange(int(seconds * SR)) / SR
    rows = [np.sin(2 * np.pi * 440.0 * t), 0.5 * np.sin(2 * np.pi * 97.0 * t)]
    rows += [0.3 * rng.standard_normal(t.shape) for _ in range(batch - 2)]
    return np.stack(rows[:batch]).astype(np.float32)


@pytest.fixture(scope="module")
def clip_pair():
    """2 x 9.3 s (L not a hop multiple) float32 clips, JAX f32 reference."""
    y = _signals(np.random.default_rng(0), 2, 9.3)
    ref = np.asarray(jax_cqt.cqt(jnp.asarray(y), P_JAX,
                                 conv_dtype=jnp.float32))
    return y, ref


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_downsample2_matches_time_major_cascade(rng, dtype):
    """Kernel A's plain FIR against the JAX package's decimation
    (cqt_pallas.downsample2_tm), float32 and raw-int16 input."""
    y = rng.standard_normal((3, 5001)).astype(np.float32)
    scale = 1.0
    if dtype == "int16":
        y = (y * 8000).astype(np.int16)
        scale = 1 / 32768.0
    ref = np.asarray(jax_cqt_pallas.downsample2_tm(
        jnp.asarray(y.T), jax_cqt.halfband_taps(), out_scale=scale))
    got = cqt.downsample2(torch.from_numpy(y),
                          cqt.decimation_taps(1, scale)).numpy()
    np.testing.assert_allclose(got, ref.T, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("L", [1, 2, 200, 257, 258, 1001])
def test_pad_stream_is_numpy_reflect(rng, L):
    """Both branches of pad_stream (slices for one reflection, an index
    table for repeated reflection) equal np.pad(mode='reflect') + zeros,
    for int16 and float streams."""
    head = 256
    y = (rng.standard_normal((2, L)) * 1000).astype(np.int16)
    ref = np.pad(y, ((0, 0), (head, head + 1)), mode="reflect")
    ref = np.pad(ref, ((0, 0), (0, 40)))
    got = cqt.pad_stream(torch.from_numpy(y), head, ref.shape[1])
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), ref)
    got = cqt.pad_stream(torch.from_numpy(y.astype(np.float32)), head, 10)
    np.testing.assert_array_equal(got.numpy(), ref[:, :L + 2 * head + 1])


@pytest.mark.parametrize("n_fft,L", [(512, 5137), (1024, 6000), (512, 300)])
def test_cascade_pad_matches_jax_padded_stream(rng, n_fft, L):
    """Kernel A's contract (plain version): the next octave's buffer is
    the decimated stream reflect-padded by (head, head+1) exactly as
    jnp.pad, then zero — including streams shorter than the pad."""
    head = n_fft // 2
    y = (rng.standard_normal((2, L)) * 8000).astype(np.int16)
    L_out = (L - 1) // 2 + 1
    ref = np.asarray(jax_cqt_pallas.downsample2_tm(
        jnp.asarray(y.T), jax_cqt.halfband_taps(), out_scale=1 / 32768.0))
    ref_pad = np.asarray(jax_cqt_pallas._pad_signal_for_starts(
        jnp.asarray(ref), [0], n_fft)).T
    buf = cqt.pad_stream(torch.from_numpy(y), head,
                         cqt_cuda.padded_length(L, n_fft))
    length = cqt_cuda.padded_length(L_out, n_fft)
    out = torch.full((2, length), float("nan"))
    cqt_cuda.cascade_pad(buf, head, L, L_out, out,
                         cqt.decimation_taps(1, 1 / 32768.0))
    out = out.numpy()
    assert out.shape == (2, length)
    n = L_out + 2 * head + 1
    np.testing.assert_allclose(out[:, :n], ref_pad[:, :n], rtol=1e-5,
                               atol=1e-6)
    assert np.all(out[:, n:] == 0)
    assert cqt_cuda.cascade_pad.launches == 0   # CPU: plain version


def test_plain_cqt_matches_jax_xla(clip_pair):
    y, ref = clip_pair
    got = cqt.cqt(torch.from_numpy(y), P).numpy()
    assert got.shape == ref.shape == (2, 288, 1 + y.shape[1] // 4410)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_kernel_pipeline_matches_jax_xla(clip_pair):
    """cqt_cuda's geometry (padded buffers, frame starts, octave rows)
    through the kernels' plain versions, f32 streams."""
    y, ref = clip_pair
    got = cqt_cuda.cqt_cuda(torch.from_numpy(y), P,
                            stream_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    assert cqt_cuda.octave_response.launches == 0


def test_plain_cqt_matches_pallas_interpret(rng):
    """Against the JAX package's fused front-end (interpret mode) at the
    geometry of tests/test_cqt.py::test_compute_cqt_pallas_accepts_int16."""
    sr = 8000
    x16 = (rng.uniform(-0.6, 0.6, sr * 2) * 32767).astype(np.int16)
    pj = jax_cqt.CQTParams(sr=sr, hop=1600, bins_per_octave=12, octaves=3)
    pt = cqt.CQTParams(sr=sr, hop=1600, bins_per_octave=12, octaves=3)
    ref = np.asarray(jax_compute_cqt(jnp.asarray(x16[None]), pj,
                                     use_pallas=True, conv_dtype="float32"))
    for fn in (lambda y: cqt.cqt(y, pt),
               lambda y: cqt_cuda.cqt_cuda(y, pt,
                                           stream_dtype=torch.float32)):
        got = fn(torch.from_numpy(x16[None])).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_int16_input_matches_float(rng):
    yf = _signals(rng, 2, 3.0)
    yi = np.round(yf * 32768.0).clip(-32768, 32767).astype(np.int16)
    a = cqt.cqt(torch.from_numpy(yi), P).numpy()
    b = cqt.cqt(torch.from_numpy(yi.astype(np.float32) / 32768.0), P).numpy()
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3)
    c = cqt_cuda.cqt_cuda(torch.from_numpy(yi), P,
                          stream_dtype=torch.float32).numpy()
    np.testing.assert_allclose(c, b, rtol=1e-3, atol=1e-3)


def test_bf16_streams_close_to_f32(clip_pair):
    """bf16 stream storage (Config.cqt_conv_dtype's default) stays within
    bf16 quantization, 2% of peak, of the f32 reference."""
    y, ref = clip_pair
    for fn in (cqt.cqt, cqt_cuda.cqt_cuda):
        got = fn(torch.from_numpy(y), P, stream_dtype=torch.bfloat16).numpy()
        assert np.max(np.abs(got - ref)) < 0.02 * np.max(ref)


def test_odd_batch_matches_jax(rng):
    """B = 3: no lane padding in the port, any batch runs."""
    y = rng.standard_normal((3, SR)).astype(np.float32)
    ref = np.asarray(jax_cqt.cqt(jnp.asarray(y), P_JAX))
    got = cqt_cuda.cqt_cuda(torch.from_numpy(y), P,
                            stream_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_frontend_switch_and_dtypes(rng):
    y = torch.from_numpy(rng.standard_normal((1, SR)).astype(np.float32))
    a = compute_cqt(y, P, use_kernels=False, conv_dtype="float32")
    b = cqt.cqt(y, P, stream_dtype=torch.float32)
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        compute_cqt(y, P, conv_dtype="float16")
    with pytest.raises(ValueError, match="int16"):
        cqt.cqt(torch.zeros(1, SR, dtype=torch.int32), P)
