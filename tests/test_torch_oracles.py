"""PyTorch port: the CQT oracles against the JAX package's, then the port's
plain CQT against the port's oracles, on the CPU.

ops/cqt_oracle.py (direct convolution) and ops/librosa_ref.py (the
librosa 0.9.2 + resampy 0.3.1 algorithm) are the port's float64 torch
copies of the JAX package's numpy oracles: on the same seeded inputs they
agree to rtol 1e-9 (the JAX direct oracle rounds its float64 result to
float32, so the port's float64 value must lie within half a float32 ulp
of it, plus rtol 1e-9). Then the port's plain CQT (ops/cqt.py, float32
streams, what kernels A and B compute on the card) is held to the port's
oracles at the bars and geometries of tests/test_cqt.py:123-160 and
tests/test_cqt_librosa.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_key_estimation_tpu.ops import cqt_oracle as jax_oracle
from audio_key_estimation_tpu.ops import librosa_ref as jax_ref
from audio_key_estimation_tpu.ops.cqt import CQTParams as JaxCQTParams
from audio_key_estimation_tpu.ops.cqt import cqt as jax_cqt

from audio_key_estimation_torch.ops import cqt
from audio_key_estimation_torch.ops import librosa_ref
from audio_key_estimation_torch.ops.cqt_oracle import oracle_cqt
from audio_key_estimation_torch.ops.librosa_ref import (C1_HZ, ParameterError,
                                                        librosa_cqt,
                                                        librosa_resample,
                                                        resampy_resample)

RTOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The oracles run thousands of small tensor ops. Beside the suite's
    other workers, torch's intra-op threads contend for the cores and
    each op waits for all of them (20-50x slower, measured), so this
    module runs on one thread and gives the worker's count back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _oracle_signal(sr, octaves, seconds, seed=1):
    """tests/test_cqt.py::_oracle_case's input: noise plus one tone per
    octave on an exact bin centre."""
    p = cqt.CQTParams(sr=sr, hop=round(sr / 5), bins_per_octave=36,
                      octaves=octaves)
    rng = np.random.default_rng(seed)
    L = int(seconds * sr)
    tt = np.arange(L) / sr
    y = (rng.normal(size=(1, L)) * 0.1).astype(np.float32)
    for o in range(octaves):
        f = p.fmin * 2.0 ** (o + 13 / 36)
        y[0] += 0.15 * np.sin(2 * np.pi * f * tt).astype(np.float32)
    return p, y


def _fixture(sr=22050, seconds=2.5, n_bins=216, bpo=36, seed=0):
    """tests/test_cqt_librosa.py::_fixture: tones on exact transform bins
    spread over every octave + noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    y = np.zeros_like(t, dtype=np.float64)
    for o in range(n_bins // bpo):
        k = o * bpo + int(rng.integers(2, bpo - 2))
        f = C1_HZ * 2 ** (k / bpo)
        y += 0.3 * np.sin(2 * np.pi * f * t + rng.uniform(0, 6))
    y += 0.02 * rng.standard_normal(len(t))
    return y.astype(np.float32)


def _magnitudes(y, p) -> np.ndarray:
    """The port's plain CQT with float32 streams, as magnitudes (the
    float32 log1p output undone in float64)."""
    out = cqt.cqt(torch.as_tensor(y), p, stream_dtype=torch.float32)
    return torch.expm1(out.double()).numpy()


# ---------------------------------------------------------------------------
# the port's oracles against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sr,octaves", [(8000, 6), (22050, 8)])
@pytest.mark.parametrize("log1p", [True, False])
def test_direct_oracle_matches_jax(sr, octaves, log1p):
    """oracle_cqt on two 2 s clips at tests/test_cqt.py's oracle
    geometries: within half a float32 ulp (the JAX oracle's own rounding)
    plus rtol 1e-9 of the JAX oracle, row by row."""
    p, y = _oracle_signal(sr, octaves, 2)
    y = np.concatenate([y, 0.5 * y[:, ::-1]])
    got = oracle_cqt(y, p, log1p=log1p)
    assert got.dtype == torch.float64 and got.shape == (2, p.n_bins, 11)
    ref = jax_oracle.oracle_cqt(y, JaxCQTParams(
        sr=sr, hop=p.hop, bins_per_octave=36, octaves=octaves), log1p=log1p)
    slack = 0.5 * np.spacing(np.abs(ref)) + RTOL * np.abs(ref)
    assert (np.abs(got.numpy() - ref) <= slack).all()


def test_direct_oracle_too_short_raises():
    """The reflect pad (half the lowest bin's kernel + 2) must fit: the
    same ValueError as the JAX oracle."""
    p = cqt.CQTParams(sr=8000, hop=1600, bins_per_octave=36, octaves=6)
    y = np.zeros((1, 6000), np.float32)
    with pytest.raises(ValueError, match="too short"):
        jax_oracle.oracle_cqt(y, JaxCQTParams(sr=8000, hop=1600,
                                              bins_per_octave=36, octaves=6))
    with pytest.raises(ValueError, match="too short"):
        oracle_cqt(y, p)


@pytest.mark.parametrize("bpo,octaves", [(36, 6), (12, 5), (36, 4)])
def test_librosa_cqt_matches_jax(bpo, octaves):
    """librosa_cqt on a batch of two float32 clips (tests/test_cqt_librosa.py
    fixtures, seeds 0 and 1; 36 x 4 takes the early-downsample path)
    equals the JAX 1-D oracle on each row to rtol 1e-9, complex."""
    y = np.stack([_fixture(n_bins=bpo * octaves, bpo=bpo, seed=s)
                  for s in (0, 1)])
    got = librosa_cqt(y, 22050, 4416, bpo * octaves, bpo)
    assert got.dtype == torch.complex128
    for row in range(2):
        ref = jax_ref.librosa_cqt(y[row], 22050, 4416, bpo * octaves, bpo)
        assert got.shape[1:] == ref.shape
        np.testing.assert_allclose(got[row].numpy(), ref, rtol=RTOL, atol=0)


@pytest.mark.parametrize("filt", ["kaiser_fast", "kaiser_best"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("ratio", [(2, 1), (22050, 5512.5)])
def test_resamplers_match_jax(filt, dtype, ratio):
    """resampy_resample and librosa_resample (fix, scale=True) on two rows
    equal the JAX 1-D transcriptions row by row, in the input's dtype."""
    x = np.random.default_rng(1).standard_normal((2, 4001)).astype(dtype)
    got = resampy_resample(x, *ratio, filt=filt)
    got_l = librosa_resample(x, *ratio, res_type=filt, scale=True)
    assert got.dtype == got_l.dtype == torch.from_numpy(x).dtype
    for row in range(2):
        np.testing.assert_allclose(
            got[row].numpy(), jax_ref.resampy_resample(x[row], *ratio, filt),
            rtol=RTOL, atol=0)
        np.testing.assert_allclose(
            got_l[row].numpy(), jax_ref.librosa_resample(
                x[row], *ratio, res_type=filt, scale=True),
            rtol=RTOL, atol=0)


@pytest.mark.parametrize("sr,fmin,bpo", [(22050, C1_HZ * 2 ** 7, 36),
                                         (11025, C1_HZ * 2 ** 4, 12)])
def test_filter_bank_matches_jax(sr, fmin, bpo):
    """constant_q, constant_q_lengths and sparsify_rows of its FFT equal
    the JAX transcriptions."""
    basis, lengths = librosa_ref.constant_q(sr, fmin, bpo, bpo)
    ref_basis, ref_lengths = jax_ref.constant_q(sr, fmin, bpo, bpo)
    np.testing.assert_allclose(lengths.numpy(), ref_lengths, rtol=RTOL)
    np.testing.assert_allclose(
        librosa_ref.constant_q_lengths(sr, fmin, bpo, bpo).numpy(),
        jax_ref.constant_q_lengths(sr, fmin, bpo, bpo), rtol=RTOL)
    np.testing.assert_allclose(basis.numpy(), ref_basis, rtol=RTOL,
                               atol=RTOL * np.abs(ref_basis).max())
    fft = np.fft.fft(ref_basis, axis=1)
    got = librosa_ref.sparsify_rows(fft).numpy()
    ref = jax_ref.sparsify_rows(fft)
    np.testing.assert_array_equal(got == 0, ref == 0)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_librosa_hop_divisibility_raises(impl):
    """The served geometry — hop round(22050/5) = 4410 with 8 octaves —
    violates librosa 0.9.2's hop rule and raises, in both copies."""
    y = _fixture(seconds=1.0)
    fn = librosa_cqt if impl == "port" else jax_ref.librosa_cqt
    err = ParameterError if impl == "port" else jax_ref.ParameterError
    with pytest.raises(err, match="hop_length"):
        fn(y, 22050, 4410, 288, 36)


# ---------------------------------------------------------------------------
# the port's plain CQT against the port's oracles
# ---------------------------------------------------------------------------

def _boundary_bar(y, p, oracle, jax_fast: bool) -> list:
    """Per octave, the bar of every frame: tests/test_cqt.py:157's 0.8,
    or, where the JAX fast CQT itself reads more on this input (its
    multirate reflect boundary: 0.870 at octave 0 for the 3 s clip;
    ROADMAP.md Queue 3, faults in the reference), the JAX fast CQT's own
    distance plus 1e-3 (tests/test_cqt_pallas.py:80's bar)."""
    if not jax_fast:
        return [0.8] * p.octaves
    jp = JaxCQTParams(sr=p.sr, hop=p.hop, bins_per_octave=36,
                      octaves=p.octaves)
    ref = np.asarray(jax.jit(lambda x: jax_cqt(x, jp, log1p=False))(
        jnp.asarray(y)))
    bars = []
    for o in range(p.octaves):
        sl = slice(o * 36, (o + 1) * 36)
        d = np.abs(ref[:, sl] - oracle[:, sl]).max() / oracle[:, sl].max()
        bars.append(max(0.8, d + 1e-3))
    return bars


@pytest.mark.parametrize("sr,octaves,seconds,margin", [
    (8000, 6, 8, 10), (22050, 8, 8, 10), (22050, 8, 3, 4)])
def test_fast_cqt_matches_direct_convolution_oracle(sr, octaves, seconds,
                                                    margin):
    """tests/test_cqt.py:140-160 on the port: every octave of the plain
    multirate CQT agrees with the exact full-rate oracle on interior
    frames to < 1.5% of the octave's peak, every frame < 0.8, the top
    octave < 1% on every frame. The JAX test's 8 s clips with its 2 s
    margin, and a 3 s clip whose 0.8 s margin (4 frames) covers the
    lowest bin's half kernel (~0.79 s); there the JAX fast CQT's own
    boundary frames lie 0.870 of octave 0's peak off the oracle, so every
    frame is held to the JAX fast CQT's distance plus 1e-3 where that
    exceeds 0.8 (_boundary_bar)."""
    p, y = _oracle_signal(sr, octaves, seconds)
    fast = _magnitudes(y, p)
    oracle = oracle_cqt(y, p, log1p=False).numpy()
    T = fast.shape[-1]
    assert T == oracle.shape[-1] and T > 2 * margin
    m = margin
    bars = _boundary_bar(y, p, oracle, jax_fast=seconds < 8)
    for o in range(octaves):
        sl = slice(o * 36, (o + 1) * 36)
        scale = max(oracle[:, sl].max(), 1e-6)
        interior = np.abs(fast[:, sl, m:T - m]
                          - oracle[:, sl, m:T - m]).max() / scale
        full = np.abs(fast[:, sl] - oracle[:, sl]).max() / scale
        assert interior < 0.015, f"octave {o}: interior rel {interior:.4f}"
        assert full < bars[o], f"octave {o}: boundary rel {full:.4f}"
    sl = slice((octaves - 1) * 36, octaves * 36)
    scale = max(oracle[:, sl].max(), 1e-6)
    assert np.abs(fast[:, sl] - oracle[:, sl]).max() / scale < 0.01


LIBROSA_BARS = {
    # (bpo, octaves): (interior, boundary) for the lowest octave, others
    (36, 6): ((0.025, 0.035), (0.008, 0.010)),
    (12, 5): ((0.035, 0.045), (0.015, 0.02)),
    (36, 4): ((0.08, 0.30), (0.012, 0.05)),     # early downsample
}


@pytest.mark.parametrize("bpo,octaves", list(LIBROSA_BARS))
def test_fast_cqt_matches_librosa_algorithm(bpo, octaves):
    """tests/test_cqt_librosa.py:57-100 on the port: the plain CQT
    against the port's librosa-algorithm oracle, per octave, interior
    and boundary frames, relative to the octave's peak, T trimmed to
    the shorter."""
    y = _fixture(n_bins=bpo * octaves, bpo=bpo)
    p = cqt.CQTParams(sr=22050, hop=4416, bins_per_octave=bpo,
                      octaves=octaves)
    ours = _magnitudes(y, p)[0]
    ref = librosa_cqt(y, 22050, 4416, bpo * octaves, bpo).abs().numpy()
    T = min(ours.shape[1], ref.shape[1])
    ours, ref = ours[:, :T], ref[:, :T]
    low, rest = LIBROSA_BARS[(bpo, octaves)]
    for o in range(octaves):
        a, b = ours[o * bpo:(o + 1) * bpo], ref[o * bpo:(o + 1) * bpo]
        peak = b.max()
        d_int = np.abs(a[:, 1:-1] - b[:, 1:-1]).max() / peak
        d_bnd = max(np.abs(a[:, 0] - b[:, 0]).max(),
                    np.abs(a[:, -1] - b[:, -1]).max()) / peak
        tol_int, tol_bnd = low if o == 0 else rest
        assert d_int < tol_int, (o, d_int)
        assert d_bnd < tol_bnd, (o, d_bnd)


def test_resampy_halving_preserves_tone():
    """The port's kaiser_fast transcription: a mid-band sine downsampled
    2x keeps amplitude and frequency (tests/test_cqt_librosa.py:113)."""
    sr = 8000
    t = np.arange(2 * sr) / sr
    f0 = 440.0
    y = np.sin(2 * np.pi * f0 * t)
    d = resampy_resample(y, 2, 1, filt="kaiser_fast").numpy()
    ideal = np.sin(2 * np.pi * f0 * np.arange(len(d)) / (sr / 2))
    err = np.abs(d[100:-100] - ideal[100:len(d) - 100])
    assert err.max() < 5e-3, err.max()


def test_librosa_resample_scale_energy():
    """librosa resample(scale=True) multiplies amplitude by sqrt(2) on a
    2x downsample (tests/test_cqt_librosa.py:128)."""
    y = np.random.default_rng(1).standard_normal(4096)
    d = librosa_resample(y, 2, 1, res_type="kaiser_fast", scale=True).numpy()
    assert len(d) == 2048
    ratio = np.sqrt(np.mean(d[64:-64] ** 2) / np.mean(y ** 2))
    assert 0.85 < ratio < 1.15, ratio
