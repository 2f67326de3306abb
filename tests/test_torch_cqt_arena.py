"""PyTorch port: the CQT front-end's one-launch plumbing, on the CPU.

cqt_cuda runs kernel A's octave steps into one stream arena and then
kernel B once for every octave, reading per-octave tables (offset,
length, window starts, scales) and the bank's TF32 split in the mma's
fragment order. The CUDA kernels run on the card only (chip_smoke.py);
here the tables are checked as Python builds them, the plain version of
the one-launch entry against the per-octave plain version, the split
product's arithmetic against the 1e-4 bar, and the whole orchestration
against ops.cqt.cqt and the JAX package's fused front-end in interpret
mode. Bars: tests/test_cqt_pallas.py:47 (rtol/atol 1e-4, f32 streams)
and :90 (2% of peak, bf16 streams).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_key_estimation_tpu.ops import cqt as jax_cqt
from audio_key_estimation_tpu.ops.frontend import compute_cqt as jax_compute_cqt

from audio_key_estimation_torch.ops import cqt, cqt_cuda

SR = 8000
GEOMETRIES = [  # (sr, hop, bins/octave, octaves, samples)
    (8000, 1600, 12, 3, 12000), (22050, 4410, 36, 8, 30000),
    (22050, 4410, 36, 4, 9001), (8000, 1600, 12, 1, 5000)]


def _clips(rng, batch, n, int16=True):
    y = rng.uniform(-0.6, 0.6, (batch, n)).astype(np.float32)
    return np.round(y * 32767).astype(np.int16) if int16 else y


@pytest.mark.parametrize("sr,hop,bpo,octaves,L", GEOMETRIES)
def test_arena_layout(sr, hop, bpo, octaves, L):
    """Octaves >= 1 sit back to back in the arena, 8-sample aligned (the
    kernels' 16-byte loads), and every window of every octave lies inside
    its own stream."""
    p = cqt.CQTParams(sr=sr, hop=hop, bins_per_octave=bpo, octaves=octaves)
    n_fft = cqt.kernel_bank(p)["n_fft"]
    lay = cqt_cuda.arena_layout(L, octaves, n_fft)
    assert lay.lens == tuple(cqt.stream_lengths(L, octaves))
    assert lay.lengths == tuple(cqt_cuda.padded_length(n, n_fft)
                                for n in lay.lens)
    assert lay.offsets[0] == 0 and len(lay.offsets) == octaves
    ends = [off + n for off, n in zip(lay.offsets[1:], lay.lengths[1:])]
    assert list(lay.offsets[2:]) == ends[:-1]
    assert lay.width == (ends[-1] if ends else 0)
    assert all(v % 8 == 0 for v in (*lay.offsets, *lay.lengths, lay.width))
    n_frames = 1 + L // hop
    for o in range(octaves):
        assert max(cqt._frame_starts(hop, o, n_frames)) + n_fft \
            <= lay.lengths[o]


def test_constants_tables():
    """_constants: one (octaves, T) starts table and one (octaves, bpo)
    scales table, rows equal to the per-octave builders."""
    p = cqt.CQTParams(sr=SR, hop=1600, bins_per_octave=12, octaves=3)
    c = cqt_cuda._constants(p, 9, 1 / 32768.0, "cpu")
    assert c.starts.dtype == torch.int32 and c.starts.shape == (3, 9)
    assert c.scales.dtype == torch.float32 and c.scales.shape == (3, 12)
    for o in range(3):
        assert c.starts[o].tolist() == cqt._frame_starts(1600, o, 9)
        np.testing.assert_array_equal(
            c.scales[o].numpy(), cqt.octave_scales(p, o, 1 / 32768.0))
    np.testing.assert_array_equal(c.bank.t.numpy(), cqt.bank_matrix(p).T)


def test_tf32_round():
    """cvt.rna.tf32.f32: 10 mantissa bits, ties away from zero."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    x = np.array([1.0, 1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12,
                  3 * 2 ** -11 + 1], np.float32)
    got = cqt_cuda.tf32_round(x)
    np.testing.assert_array_equal(
        got, [one, one + ulp, -(one + ulp), one, one + 2 * ulp])
    assert np.all(got.view(np.uint32) & 0x1FFF == 0)


@pytest.mark.parametrize("sr,hop,bpo,octaves", [(22050, 4410, 36, 8),
                                                (8000, 1600, 12, 3)])
def test_bank_fragments(sr, hop, bpo, octaves):
    """hi + lo is the bank to TF32's second rounding, hi and lo are TF32
    values, and the fragment order is mma.m16n8k8's B operand."""
    p = cqt.CQTParams(sr=sr, hop=hop, bins_per_octave=bpo, octaves=octaves)
    bank_t = np.ascontiguousarray(cqt.bank_matrix(p).T)      # (2 bpo, n_fft)
    n_fft = bank_t.shape[1]
    hi, lo = cqt_cuda.bank_fragments(bank_t)
    assert hi.shape == lo.shape == (n_fft // 8, 32, 18)
    for part in (hi, lo):
        assert np.all(part.view(np.uint32) & 0x1FFF == 0)
    rng = np.random.default_rng(1)
    for _ in range(200):
        s, lane, j, r = (rng.integers(n_fft // 8), rng.integers(32),
                         rng.integers(9), rng.integers(2))
        k, n = 8 * s + lane % 4 + 4 * r, 8 * j + lane // 4
        want = bank_t[n, k] if n < 2 * bpo else 0.0
        got = float(hi[s, lane, 2 * j + r]) + float(lo[s, lane, 2 * j + r])
        assert abs(got - want) <= 2.0 ** -21 * abs(want)


@pytest.mark.parametrize("stream_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int16", [True, False])
def test_split_tf32_product_meets_the_bar(rng, stream_dtype, int16):
    """Kernel B's arithmetic, emulated: x_lo*b_hi + x_hi*b_lo + x_hi*b_hi
    with TF32 parts, float32 sums (x_lo = 0 for a bf16 stream), gives the
    log1p responses within 1e-4 of the float32 product."""
    p = cqt.CQTParams(sr=22050, hop=4410)
    c = cqt_cuda._constants(p, 7, 1 / 32768.0 if int16 else 1.0, "cpu")
    hi, lo = cqt_cuda.bank_fragments(c.bank.t.numpy())
    n_fft = c.bank.t.shape[1]
    # undo the fragment order: (n_fft, 72) hi and lo
    s, lane, j, r = np.meshgrid(np.arange(n_fft // 8), np.arange(32),
                                np.arange(9), np.arange(2), indexing="ij")
    k, n = 8 * s + lane % 4 + 4 * r, 8 * j + lane // 4
    b_hi = np.zeros((n_fft, 72), np.float32)
    b_lo = np.zeros((n_fft, 72), np.float32)
    b_hi[k, n] = hi.reshape(s.shape)
    b_lo[k, n] = lo.reshape(s.shape)
    y = _clips(rng, 2, 3 * 4410 + n_fft, int16)
    x = torch.from_numpy(y)
    x = x.to(stream_dtype) if not int16 else x
    frames = np.stack([x[:, t * 4410:t * 4410 + n_fft].float().numpy()
                       for t in range(3)], axis=1)         # (B, T, n_fft)
    x_hi = cqt_cuda.tf32_round(frames)
    x_lo = cqt_cuda.tf32_round(frames - x_hi)
    if stream_dtype == torch.bfloat16 and not int16:
        assert not x_lo.any()
    split = (x_lo @ b_hi + x_hi @ b_lo + x_hi @ b_hi)[..., :72]
    exact = frames @ c.bank.t.numpy().T
    scales = c.scales[0].numpy()

    def log1p_mag(r):
        return np.log1p(np.hypot(r[..., :36], r[..., 36:]) * scales)
    np.testing.assert_allclose(log1p_mag(split), log1p_mag(exact),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("stream_dtype", [torch.float32, torch.bfloat16])
def test_cascade_arena_is_the_plain_chain(rng, stream_dtype):
    """Kernel A's steps into the arena equal cascade_pad_plain chained
    octave by octave, each in its own buffer."""
    p = cqt.CQTParams(sr=SR, hop=1600, bins_per_octave=12, octaves=3)
    n_fft = cqt.kernel_bank(p)["n_fft"]
    head = n_fft // 2
    y = torch.from_numpy(_clips(rng, 3, 12000))
    lay = cqt_cuda.arena_layout(12000, 3, n_fft)
    x0 = cqt.pad_stream(y, head, lay.lengths[0])
    arena = cqt_cuda.cascade_arena(x0, lay, head, 1 / 32768.0, stream_dtype)
    assert arena.shape == (3, lay.width) and arena.dtype == stream_dtype
    buf = x0
    for o, got in enumerate(cqt_cuda.octave_streams(x0, arena, lay)[1:], 1):
        buf = cqt_cuda.cascade_pad_plain(
            buf, head, lay.lens[o - 1], lay.lens[o], lay.lengths[o],
            cqt.decimation_taps(o, 1 / 32768.0), stream_dtype)
        assert torch.equal(got, buf)
    assert cqt_cuda.cascade_pad.launches == 0


@pytest.mark.parametrize("stream_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int16", [True, False])
def test_arena_entry_equals_per_octave_plain(rng, stream_dtype, int16):
    """The plain version of the one-launch kernel B writes each octave's
    rows exactly as octave_response_plain on that octave's stream."""
    p = cqt.CQTParams(sr=SR, hop=1600, bins_per_octave=12, octaves=3)
    n_fft = cqt.kernel_bank(p)["n_fft"]
    head = n_fft // 2
    y = torch.from_numpy(_clips(rng, 2, 9000, int16))
    in_scale = cqt.input_scale(y)
    lay = cqt_cuda.arena_layout(9000, 3, n_fft)
    x0 = cqt.pad_stream(y, head, lay.lengths[0])
    arena = cqt_cuda.cascade_arena(x0, lay, head, in_scale, stream_dtype)
    c = cqt_cuda._constants(p, 1 + 9000 // 1600, in_scale, "cpu")
    out = torch.full((2, 36, 6), float("nan"))
    cqt_cuda.octave_response(x0, arena, lay, c.starts, c.bank, c.scales, out)
    for o, buf in enumerate(cqt_cuda.octave_streams(x0, arena, lay)):
        ref = cqt.octave_response(buf, c.starts[o], c.bank.t.T, c.scales[o])
        rows = slice((2 - o) * 12, (3 - o) * 12)
        assert torch.equal(out[:, rows], ref)
    assert cqt_cuda.octave_response.launches == 0


@pytest.mark.parametrize("stream_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,n", [(2, 12000), (3, 9001)])
def test_cqt_cuda_matches_plain_and_pallas_interpret(rng, stream_dtype,
                                                     batch, n):
    """cqt_cuda on CPU tensors (the kernels' plain versions through the
    arena orchestration) against ops.cqt.cqt and the JAX package's
    cqt_pallas in interpret mode: 3 octaves, int16 clips."""
    y = _clips(rng, batch, n)
    pj = jax_cqt.CQTParams(sr=SR, hop=1600, bins_per_octave=12, octaves=3)
    pt = cqt.CQTParams(sr=SR, hop=1600, bins_per_octave=12, octaves=3)
    sd = getattr(torch, stream_dtype)
    got = cqt_cuda.cqt_cuda(torch.from_numpy(y), pt, stream_dtype=sd).numpy()
    plain = cqt.cqt(torch.from_numpy(y), pt, stream_dtype=sd).numpy()
    ref = np.asarray(jax_compute_cqt(jnp.asarray(y), pj, use_pallas=True,
                                     conv_dtype=stream_dtype))
    assert got.shape == ref.shape == (batch, 36, 1 + n // 1600)
    np.testing.assert_array_equal(got, plain)
    if stream_dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    else:
        assert np.max(np.abs(got - ref)) < 0.02 * np.max(ref)
