"""PyTorch port: the variants' ops, local-mode serving and its CLI against
the JAX package.

The memory add (pc2p_mem), the learned octave pool (p2pc_conv) and the
local head's sliding max against their JAX functions on seeded inputs;
`predict_files_local` against the JAX `predict_files_local` on tiny WAVs
(window count, start and end, names, key probabilities within 1e-4, as
tests/test_predict.py:116-141 and tests/test_torch_predict.py:40-56);
`predict_files` of the 12-bin and learned-pool variants against the JAX
`predict_files`; `cli.predict --local_windows`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from audio_key_estimation_tpu.config import Config
from audio_key_estimation_tpu.ops import equivariant as jax_eqv
from audio_key_estimation_tpu.ops import pooling as jax_pooling
from audio_key_estimation_tpu.predict import KeyEstimator as JaxEstimator

from audio_key_estimation_torch.cli import predict as cli
from audio_key_estimation_torch.data import audio_io
from audio_key_estimation_torch.models import PitchClassNet
from audio_key_estimation_torch.models.convert import state_dict_from_jax
from audio_key_estimation_torch.ops import equivariant, pooling
from audio_key_estimation_torch.predict import (KeyEstimator,
                                                LocalPrediction,
                                                WindowPrediction)
from torch_parity import jax_variables

CFG = Config(octaves=4, num_layers=2, conv_layers=1, n_filters=2,
             kernel_size=3, head_layers=1, genre=True, frames=5,
             loc_window_size=2, cqt_conv_dtype="float32")
SR = 8000


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("c1,c2,p,rows", [(2, 4, 72, 36), (1, 4, 72, 24),
                                          (3, 6, 36, 12)])
def test_memory_add_matches_jax(rng, c1, c2, p, rows):
    """Groups of c2 / c1 consecutive channels summed, added over
    row-major pitch blocks (a wrong grouping passes only at c1 = 1)."""
    pitches = rng.normal(size=(2, p, 9, c1)).astype(np.float32)
    pcs = rng.normal(size=(2, rows, 9, c2)).astype(np.float32)
    ref = np.asarray(jax_eqv.pc_to_pitch_memory_add(
        jnp.asarray(pitches), jnp.asarray(pcs), rows))
    got = equivariant.pc_to_pitch_memory_add(_nchw(pitches), _nchw(pcs))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("p,kd", [(36, 1), (30, 1), (36, 3)])
def test_octave_dilated_conv_matches_jax(rng, p, kd):
    """Dilation 12 on the pitch axis; a pitch axis short of a multiple of
    12 is padded with zeros (the JAX package's divergence from the
    reference's -inf)."""
    ksize = -(-p // 12)
    x = rng.normal(size=(2, p, 11, 3)).astype(np.float32)
    w = rng.normal(size=(ksize, kd, 3, 3)).astype(np.float32)
    b = rng.normal(size=3).astype(np.float32)
    ref = np.asarray(jax_pooling.octave_dilated_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), pitches_in=p))
    got = pooling.octave_dilated_conv(
        _nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
        torch.from_numpy(b))
    assert tuple(got.shape) == (2, 3, 12, 11 - kd + 1)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t,window", [(40, 7), (50, 50), (12, 13)])
def test_sliding_time_max_matches_reduce_window(rng, t, window):
    x = rng.normal(size=(2, 12, t, 1)).astype(np.float32)
    ref = np.asarray(lax.reduce_window(
        jnp.asarray(x), -jnp.inf, lax.max, (1, 1, window, 1), (1, 1, 1, 1),
        "VALID"))
    got = pooling.sliding_time_max(_nchw(x), window)
    assert tuple(got.shape) == (2, 1, 12, max(t - window + 1, 0))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)


def _wavs(tmp_path, seconds=(5.0, 3.3)):
    paths = []
    for i, (f, s) in enumerate(zip((330.0, 440.0), seconds)):
        t = np.arange(int(SR * s)) / SR
        y = 0.4 * np.sin(2 * np.pi * f * t) + 0.2 * np.sin(3 * np.pi * f * t)
        paths.append(str(tmp_path / f"s{i}.wav"))
        audio_io.write_wav(paths[-1], y, SR)
    return paths


def test_predict_files_local_matches_jax(tmp_path, rng):
    """Windows of loc_window_size seconds every 1/frames seconds: 5 s at
    5 fps is 26 frames, 26 - 2 * 5 + 1 = 17 windows; 3.3 s 8."""
    _, variables = jax_variables(CFG, rng)
    paths = _wavs(tmp_path)
    ref = JaxEstimator(CFG, variables, bucket_seconds=(6,)) \
        .predict_files_local(paths, return_raw=True)
    est = KeyEstimator(CFG, state_dict_from_jax(variables), device="cpu",
                       bucket_seconds=(6,))
    got = est.predict_files_local(paths, return_raw=True)
    assert [len(g.windows) for g in got] == [len(r.windows) for r in ref] \
        == [17, 8]
    for g, r in zip(got, ref):
        assert isinstance(g, LocalPrediction)
        assert isinstance(g.windows[0], WindowPrediction)
        assert (g.windows[0].start, g.windows[0].end) == (0.0, 2.0)
        assert abs(g.windows[1].start - 0.2) < 1e-9
        assert g.key_probs.shape == (len(g.windows), 12)
        np.testing.assert_allclose(g.key_probs, r.key_probs, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(g.tonic_logits, r.tonic_logits,
                                   rtol=1e-4, atol=1e-4)
        for gw, rw in zip(g.windows, r.windows):
            assert (gw.start, gw.end, gw.key, gw.tonic, gw.genre) == \
                (rw.start, rw.end, rw.key, rw.tonic, rw.genre)
    # the global prediction is unchanged by a local call on the same model
    again = est.predict_files(paths, return_raw=True)
    glob = JaxEstimator(CFG, variables, bucket_seconds=(6,)).predict_files(
        paths, return_raw=True)
    for g, r in zip(again, glob):
        np.testing.assert_allclose(g.key_probs, r.key_probs, rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("variant", [dict(only_semitones=True),
                                     dict(p2pc_conv=True, stay_sixth=True)])
def test_predict_files_variant_matches_jax(tmp_path, rng, variant):
    """Serving a variant end to end (only_semitones: the 12-bin CQT)."""
    cfg = CFG.replace(**variant)
    _, variables = jax_variables(cfg, rng)
    paths = _wavs(tmp_path)
    ref = JaxEstimator(cfg, variables, bucket_seconds=(6,)).predict_files(
        paths, return_raw=True)
    got = KeyEstimator(cfg, state_dict_from_jax(variables), device="cpu",
                       bucket_seconds=(6,)).predict_files(paths,
                                                          return_raw=True)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.key_probs, r.key_probs, rtol=1e-4,
                                   atol=1e-4)
        assert (g.key, g.tonic, g.genre) == (r.key, r.tonic, r.genre)


def test_cli_local_windows_runs(tmp_path, capsys):
    cfg = CFG.replace(genre=False)
    ckpt = str(tmp_path / "best_model.pt")
    torch.save(PitchClassNet(cfg).state_dict(), ckpt)
    paths = _wavs(tmp_path)
    flags = ["--octaves", "4", "--num_layers", "2", "--conv_layers", "1",
             "--n_filters", "2", "--kernel_size", "3", "--head_layers", "1",
             "--loc_window_size", "2"]
    out = cli.main(paths + flags + ["--torch_ckpt", ckpt, "--device", "cpu",
                                    "--local_windows"])
    assert set(out) == set(paths)
    assert [len(out[p].windows) for p in paths] == [17, 8]
    printed = capsys.readouterr().out
    assert all(p in printed for p in paths)
    assert "0.00-   2.00s" in printed and "conf" in printed
