"""PyTorch port: the serving API and CLI against the JAX KeyEstimator.

Same tiny PCM16 WAVs, same weights (flax init, converted with
`state_dict_from_jax`), float32 CQT streams on both sides.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from audio_key_estimation_tpu.config import Config
from audio_key_estimation_tpu.predict import KeyEstimator as JaxEstimator
from audio_key_estimation_tpu.predict import key_name as jax_key_name
from audio_key_estimation_tpu.utils.key_signatures import KEY_SIGNATURE_MAP

from audio_key_estimation_torch.cli import predict as cli
from audio_key_estimation_torch.data import audio_io
from audio_key_estimation_torch.models.convert import state_dict_from_jax
from audio_key_estimation_torch.predict import (KeyEstimator, Prediction,
                                                key_name)
from torch_parity import jax_variables

CFG = Config(octaves=4, num_layers=2, conv_layers=1, n_filters=2,
             kernel_size=3, head_layers=1, genre=True,
             cqt_conv_dtype="float32")
SR = 8000


def _wavs(tmp_path, seconds=(3.0, 2.2)):
    paths = []
    for i, (f, s) in enumerate(zip((261.6, 440.0), seconds)):
        t = np.arange(int(SR * s)) / SR
        y = 0.4 * np.sin(2 * np.pi * f * t) + 0.2 * np.sin(3 * np.pi * f * t)
        p = str(tmp_path / f"s{i}.wav")
        audio_io.write_wav(p, y, SR)
        paths.append(p)
    return paths


def test_predict_files_matches_jax(tmp_path, rng):
    _, variables = jax_variables(CFG, rng)
    paths = _wavs(tmp_path)
    ref = JaxEstimator(CFG, variables, bucket_seconds=(4,)).predict_files(
        paths, return_raw=True)
    est = KeyEstimator(CFG, state_dict_from_jax(variables), device="cpu",
                       bucket_seconds=(4,))
    got = est.predict_files(paths, return_raw=True)
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert isinstance(g, Prediction)
        np.testing.assert_allclose(g.key_probs, r.key_probs, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(g.tonic_logits, r.tonic_logits,
                                   rtol=1e-4, atol=1e-4)
        assert (g.key, g.tonic, g.genre) == (r.key, r.tonic, r.genre)
        assert abs(g.confidence - r.confidence) < 1e-4


def test_predict_files_every_encoding_matches_jax(tmp_path, rng):
    """MP3 (MPEG-2.5 at 8 kHz), float32 and 24-bit WAVs beside a PCM16
    one: the batch goes to the CQT as float32, as the JAX estimator's."""
    import struct
    import sys
    sys.path.insert(0, str(Path(__file__).parent))
    import mp3_builder as B
    paths = _wavs(tmp_path)
    y = 0.3 * np.sin(2 * np.pi * 330.0 * np.arange(int(SR * 2.6)) / SR)
    for name, fmt, bits, data in (
            ("f.wav", 3, 32, y.astype("<f4").tobytes()),
            ("i.wav", 1, 24, np.round(y * (2 ** 23 - 1)).astype("<i4")
             .view("u1").reshape(-1, 4)[:, :3].tobytes())):
        p = str(tmp_path / name)
        with open(p, "wb") as f:
            f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
            f.write(b"fmt " + struct.pack("<IHHIIHH", 16, fmt, 1, SR,
                                          SR * bits // 8, bits // 8, bits))
            f.write(b"data" + struct.pack("<I", len(data)) + data)
        paths.append(p)
    g = B.Granule(big_values=60, big_pairs=tuple(
        (int(a), int(b)) for a, b in rng.integers(-7, 8, (60, 2))),
        table_select=(10, 10, 10), global_gain=200)
    mp3 = tmp_path / "m.mp3"
    mp3.write_bytes(B.build_stream([B.build_frame_lsf(g, sr=SR)] * 30))
    paths.append(str(mp3))
    _, variables = jax_variables(CFG, rng)
    ref = JaxEstimator(CFG, variables, bucket_seconds=(4,)).predict_files(
        paths, return_raw=True)
    est = KeyEstimator(CFG, state_dict_from_jax(variables), device="cpu",
                       bucket_seconds=(4,))
    batches = []
    make_batch = est.make_batch

    def recording(waveforms, sr):
        batches.append(make_batch(waveforms, sr))
        return batches[-1]
    est.make_batch = recording
    got = est.predict_files(paths, return_raw=True)
    assert [b[0].dtype for b in batches] == [torch.float32]
    assert len(got) == len(ref) == 5
    for g_, r in zip(got, ref):
        np.testing.assert_allclose(g_.key_probs, r.key_probs, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(g_.tonic_logits, r.tonic_logits,
                                   rtol=1e-4, atol=1e-4)
        assert (g_.key, g_.tonic, g_.genre) == (r.key, r.tonic, r.genre)
    # a PCM16-only batch stays int16 end to end
    batches.clear()
    est.predict_files(paths[:2])
    assert [b[0].dtype for b in batches] == [torch.int16]


def test_key_name_agrees_on_every_signature_row(rng):
    for row in range(KEY_SIGNATURE_MAP.shape[0]):
        sig = KEY_SIGNATURE_MAP[row].astype(np.float32)
        noisy = sig + 0.05 * rng.random(12).astype(np.float32)
        for tonic in range(12):
            logits = np.eye(12, dtype=np.float32)[tonic]
            for v in (sig, noisy):
                assert key_name(v, logits) == jax_key_name(v, logits)


def test_cli_runs(tmp_path, capsys):
    cfg = CFG.replace(genre=False)
    from audio_key_estimation_torch.models import PitchClassNet
    ckpt = str(tmp_path / "best_model.pt")
    torch.save(PitchClassNet(cfg).state_dict(), ckpt)
    paths = _wavs(tmp_path)
    flags = ["--octaves", "4", "--num_layers", "2", "--conv_layers", "1",
             "--n_filters", "2", "--kernel_size", "3", "--head_layers", "1"]
    out = cli.main(paths + flags + ["--torch_ckpt", ckpt, "--device", "cpu"])
    assert set(out) == set(paths)
    printed = capsys.readouterr().out
    assert all(p in printed for p in paths) and "conf" in printed


def test_cli_defaults_to_cuda(tmp_path):
    """Without --device the CLI serves on the card: on a machine without
    CUDA it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    cfg = CFG.replace(genre=False)
    from audio_key_estimation_torch.models import PitchClassNet
    ckpt = str(tmp_path / "best_model.pt")
    torch.save(PitchClassNet(cfg).state_dict(), ckpt)
    flags = ["--octaves", "4", "--num_layers", "2", "--conv_layers", "1",
             "--n_filters", "2", "--kernel_size", "3", "--head_layers", "1"]
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(_wavs(tmp_path) + flags + ["--torch_ckpt", ckpt])


def test_unported_entry_points_raise(tmp_path):
    """What the port cannot serve raises, naming why: a JAX run
    directory (orbax best_model/) names its conversion, the CQT kernels
    on the CPU the CUDA they need. A multi_scale Config builds the
    ensemble (PitchClassNetMulti) for global and local serving."""
    from audio_key_estimation_torch.models import (PitchClassNet,
                                                   PitchClassNetMulti,
                                                   build_model)
    (tmp_path / "best_model").mkdir()
    with pytest.raises(ValueError, match="state_dict_from_jax"):
        KeyEstimator.from_checkpoint(str(tmp_path))
    multi = CFG.replace(multi_scale=True)
    est = KeyEstimator(multi, build_model(multi).state_dict(), device="cpu")
    assert isinstance(est.model, PitchClassNetMulti)
    assert isinstance(est.local_model, PitchClassNetMulti)
    with pytest.raises(ValueError, match="CUDA"):
        KeyEstimator(CFG.replace(use_pallas_cqt="on"),
                     PitchClassNet(CFG).state_dict(), device="cpu")
