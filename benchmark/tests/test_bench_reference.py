"""The plain reference against the system at tiny sizes on the CPU: the
weights' layout loads into the system, the WAV reader, the CQT, the
model (float32, and with its stacks at the configuration's bf16), the
naming of keys and a whole request from files."""

import numpy as np
import pytest
import torch

from benchmark.reference import cqt as ref_cqt
from benchmark.reference import model as ref_model
from benchmark.reference import serve as ref_serve
from benchmark.traffic import synth

SR, HOP = 22050, 4410


def cfg_of(multi: bool, stacks: str = "bfloat16") -> dict:
    return {"octaves": 8, "frames": 5, "only_semitones": False,
            "multi_scale": multi, "conv_layers": 3, "n_filters": 4,
            "num_layers": 2, "kernel_size": 7, "head_layers": 2,
            "time_pool_size": 2, "bins_per_octave": 36,
            "cqt_stream_dtype": "bfloat16", "stack_dtype": stacks,
            "reference": "model"}


def port_config(multi: bool, fused: bool = True):
    from audio_key_estimation_torch.config import Config
    return Config(multi_scale=multi, fused_convstack=fused)


def clips(n=3, seconds=7, seed=5):
    lengths = [seconds * SR - 101 * i for i in range(n)]
    return synth.pcm16_batch(lengths, seconds * SR, SR, seed, "cpu"), lengths


@pytest.mark.parametrize("multi", [False, True])
def test_layout_is_the_systems(multi):
    from audio_key_estimation_torch.models import build_model
    want = {k: tuple(v.shape) for k, v in
            build_model(port_config(multi)).state_dict().items()}
    got = {k: tuple(s) for k, s, _, _ in ref_model.spec(cfg_of(multi))}
    assert got == want


def test_wav_reader(tmp_path):
    from audio_key_estimation_torch.data import audio_io
    y, _ = clips(1, 2)
    path = str(tmp_path / "a.wav")
    synth.write_wav(path, y[0].numpy(), SR)
    got, sr = ref_serve.read_wav(path)
    want, sr2 = audio_io.decode_audio(path, raw=True)
    assert sr == sr2 == SR and got.dtype == np.int16
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bpo", [36, 12])
@pytest.mark.parametrize("stream", ["bfloat16", "float32"])
def test_cqt_is_the_systems_algorithm(bpo, stream):
    from audio_key_estimation_torch.ops import cqt as C
    y, _ = clips()
    dt = getattr(torch, stream)
    want = C.cqt(y, C.CQTParams(sr=SR, hop=HOP, bins_per_octave=bpo),
                 stream_dtype=dt)
    got = ref_cqt.cqt(y, sr=SR, hop=HOP, bins_per_octave=bpo, octaves=8,
                      stream_dtype=dt)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)


def weights(multi):
    cfg = cfg_of(multi)
    sd = ref_model.init_weights(cfg, 11, "cpu")
    y, _ = clips(4, 8, seed=9)
    mels = [ref_cqt.cqt(y, sr=SR, hop=HOP, bins_per_octave=b, octaves=8)
            for b in ((36, 12) if multi else (36,))]
    with torch.no_grad():
        ref_model.forward(sd, cfg, mels, torch.full((4,), 1 + 8 * SR // HOP),
                          mode="calibrate")
    return sd


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("stacks", ["float32", "bfloat16"])
def test_model_is_the_systems(multi, stacks):
    from audio_key_estimation_torch.models import build_model
    from audio_key_estimation_torch.models.convert import load_state_dict
    sd = weights(multi)
    model = build_model(port_config(multi, fused=stacks == "bfloat16"))
    load_state_dict(model, sd)
    model.eval()
    y, lengths = clips(3, 7, seed=13)
    seq = torch.tensor([1 + n // HOP for n in lengths])
    mels = [ref_cqt.cqt(y, sr=SR, hop=HOP, bins_per_octave=b, octaves=8)
            for b in ((36, 12) if multi else (36,))]
    with torch.no_grad():
        want = model(*[m[..., None] for m in mels], seq)
        got = ref_model.forward(sd, cfg_of(multi, stacks), mels, seq)
    # float32: the same arithmetic; bf16 stacks: a bf16 rounding that
    # flips where the two sum in another order moves an output by up to
    # ~1e-3 of its peak at these few frames
    tol = 1e-5 if stacks == "float32" else 3e-3
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=tol * w.abs().max())
    assert got[0].std(0).max() > 1e-3     # the keys answer to the audio


def test_key_names_are_the_systems():
    from audio_key_estimation_torch.predict import key_name
    rng = np.random.default_rng(0)
    for _ in range(500):
        k = rng.random(12).astype(np.float32)
        t = rng.standard_normal(12).astype(np.float32)
        assert ref_serve.key_name(k, t) == key_name(k, t)["key"]


def test_buckets():
    assert ref_serve.bucket_samples(180 * SR, SR) == 180 * SR
    assert ref_serve.bucket_samples(180 * SR + 1, SR) == 420 * SR
    assert ref_serve.bucket_samples(421 * SR, SR) == 480 * SR
    assert ref_serve.hop_of(SR, 5) == HOP


def test_a_request_from_files_is_the_systems(tmp_path):
    from audio_key_estimation_torch.predict import KeyEstimator
    sd = weights(False)
    y, lengths = clips(3, 9, seed=21)
    paths = []
    for i, n in enumerate(lengths):
        paths.append(str(tmp_path / f"{i}.wav"))
        synth.write_wav(paths[-1], y[i, :n].numpy(), SR)
    est = KeyEstimator(port_config(False), sd, device="cpu")
    preds = est.predict_files(paths, return_raw=True)
    ref = ref_serve.serve_files(sd, cfg_of(False), paths, "cpu")
    assert ref["pad"] == 60 * SR and ref["hop"] == HOP
    np.testing.assert_allclose(np.stack([p.key_probs for p in preds]),
                               ref["key"], rtol=0, atol=1e-3)
    for p in preds:
        assert p.key == ref_serve.key_name(p.key_probs, p.tonic_logits)
