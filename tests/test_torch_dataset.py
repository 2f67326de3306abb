"""PyTorch port: dataset preprocessing against the JAX package's KeyDataset.

The same synthetic corpora (songs of several lengths, two sample rates,
PCM16 and float32 / 24-bit WAVs) go through the port's
`KeyDataset(device="cpu")` (the plain PyTorch CQT) and the JAX
`KeyDataset` on the CPU (its XLA CQT), both with use_cache=False. Features
agree within the CQT bars (rtol/atol 1e-4 with float32 streams,
tests/test_cqt_pallas.py:47; 2% of the peak with bfloat16 streams, :90);
labels, window coverage, sequence lengths and every other `batches()`
array are exactly equal.
"""

import os
import struct

import numpy as np
import pytest
import torch

from audio_key_estimation_tpu.config import Config as JaxConfig
from audio_key_estimation_tpu.data import loaders as jax_loaders
from audio_key_estimation_tpu.data import synthetic as jax_synth
from audio_key_estimation_tpu.data.dataset import KeyDataset as JaxDataset
from audio_key_estimation_tpu.data.dataset import cache_path as jax_cache_path

from audio_key_estimation_torch.config import Config
from audio_key_estimation_torch.data import audio_io, loaders
from audio_key_estimation_torch.data.dataset import (PACKAGED_BLACKLIST,
                                                     KeyDataset, cache_path)

BASE = dict(octaves=4, frames=5)
FEATURES = ("mel", "mel2")


def write_encoded(path, y, sr, enc):
    """Mono WAV of y in one encoding: PCM16, 24-bit PCM or float32."""
    if enc == "pcm16":
        return audio_io.write_wav(path, y, sr)
    if enc == "f32":
        fmt, bits, data = 3, 32, np.asarray(y, "<f4").tobytes()
    else:
        v = np.round(np.clip(y, -1, 1) * (2 ** 23 - 1)).astype("<i4")
        fmt, bits, data = 1, 24, v.view("u1").reshape(-1, 4)[:, :3].tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, fmt, 1, sr,
                                      sr * bits // 8, bits // 8, bits))
        f.write(b"data" + struct.pack("<I", len(data)) + data)


def _tone(sr, seconds, f0, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    return (0.4 * np.sin(2 * np.pi * f0 * t) + 0.2 * np.sin(3 * np.pi * f0 * t)
            + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)


GS_SONGS = [("s1", 261.63, "C major", "techno"),
            ("s2", 440.0, "A minor", "hip-hop"),
            ("s3", 392.0, "G major", "techno"),
            ("s4", 329.6, "E minor", "trance"),
            ("s5", 293.7, "D major", "house")]
# (sample rate, seconds, encoding) per song: two rates, odd lengths
GS_AUDIO = [(8000, 2.37, "pcm16"), (8000, 3.1, "f32"), (16000, 1.93, "s24"),
            (8000, 2.37, "pcm16"), (16000, 2.6, "pcm16")]


def giantsteps(root, encodings=True):
    def audio(path, key, i):
        sr, sec, enc = GS_AUDIO[i]
        write_encoded(path, _tone(sr, sec, GS_SONGS[i][1], i), sr,
                      enc if encodings else "pcm16")
    return jax_synth.make_giantsteps_corpus(str(root), GS_SONGS,
                                            audio_fn=audio)


def winterreise(root):
    songs = [("HU33", "D911-01", 440.0, "D:min"),
             ("SC06", "D911-02", 330.0, "Bb:maj")]
    segs = {"HU33_D911-01": [(0.0, 3.1, "D:min"), (3.1, 6.6, "A:maj")],
            "SC06_D911-02": [(0.6, 7.0, "Bb:maj")]}

    def audio(path, name, _segs):
        i = [f"{p}_{s}" for p, s, _, _ in songs].index(name)
        write_encoded(path, _tone(8000, 6.9 + i * 0.4, songs[i][2], i), 8000,
                      ("pcm16", "f32")[i])
    return jax_synth.make_winterreise_corpus(str(root), songs,
                                             local_segments=segs,
                                             audio_fn=audio)


def _import(cfg_kw, loader_of, root, genre):
    ref = JaxDataset(genre=genre, cfg=JaxConfig(**cfg_kw), blacklist_path="",
                     use_cache=False)
    ref.import_data(loader_of(jax_loaders, root), progress=False)
    got = KeyDataset(genre=genre, cfg=Config(**cfg_kw), blacklist_path="",
                     use_cache=False, device="cpu")
    got.import_data(loader_of(loaders, root), progress=False)
    return got, ref


def _close(name, got, ref, conv_dtype):
    assert got.shape == ref.shape and got.dtype == ref.dtype, name
    if conv_dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    else:
        err = np.abs(got - ref).max()
        assert err <= 0.02 * np.abs(ref).max(), (name, err)


def assert_same_dataset(got, ref, conv_dtype, batch_size=2):
    assert len(got) == len(ref) > 0
    assert got.seq_length_max == ref.seq_length_max
    for g, r in zip(got.items, ref.items):
        assert sorted(g) == sorted(r)
        for k in r:
            if k in FEATURES:
                _close(f"{r['file']} {k}", g[k], r[k], conv_dtype)
            elif isinstance(r[k], np.ndarray):
                assert g[k].dtype == r[k].dtype, k
                np.testing.assert_array_equal(g[k], r[k], err_msg=k)
            else:
                assert g[k] == r[k] and type(g[k]) is type(r[k]), k
    for shuffle in (False, True):
        gb = list(got.batches(batch_size, shuffle=shuffle, seed=3))
        rb = list(ref.batches(batch_size, shuffle=shuffle, seed=3))
        assert len(gb) == len(rb)
        for g, r in zip(gb, rb):
            assert sorted(g) == sorted(r)
            for k in r:
                if k in FEATURES:
                    _close(f"batch {k}", g[k], r[k], conv_dtype)
                else:
                    assert g[k].dtype == r[k].dtype, k
                    np.testing.assert_array_equal(g[k], r[k], err_msg=k)


@pytest.mark.parametrize("encodings,conv_dtype", [
    (False, "float32"), (True, "float32"), (True, "bfloat16")],
    ids=["pcm16-f32", "mixed-f32", "mixed-bf16"])
def test_global_giantsteps_with_genre_matches_jax(tmp_path, encodings,
                                                  conv_dtype):
    root = giantsteps(tmp_path / "gs", encodings)
    got, ref = _import(dict(BASE, cqt_conv_dtype=conv_dtype),
                       lambda m, r: m.GiantStepsKeyLoader(r), root, True)
    assert len(got) == 5 and got[0]["genre"].sum() == 1
    assert_same_dataset(got, ref, conv_dtype)


def test_local_winterreise_matches_jax(tmp_path):
    root = winterreise(tmp_path / "w")
    kw = dict(BASE, local=True, loc_window_size=2, cqt_conv_dtype="float32")
    got, ref = _import(
        kw, lambda m, r: m.SchubertWinterreiseLoader(r, local=True), root,
        False)
    assert got[0]["key_labels"].ndim == 2
    assert any(it["window_coverage"].min() < 1 for it in got.items)
    assert_same_dataset(got, ref, "float32")


def test_local_tiled_giantsteps_matches_jax(tmp_path):
    root = giantsteps(tmp_path / "gs")
    kw = dict(BASE, local=True, loc_window_size=1, cqt_conv_dtype="float32")
    got, ref = _import(kw, lambda m, r: m.GiantStepsKeyLoader(r), root, True)
    assert_same_dataset(got, ref, "float32", batch_size=3)


def test_window_size_mode_matches_jax(tmp_path):
    """frames == 0: the hop is each file's length // window_size + 1, so a
    group holds only songs of one length (s1 and s4 share theirs)."""
    root = giantsteps(tmp_path / "gs")
    kw = dict(BASE, frames=0, window_size=150, cqt_conv_dtype="float32")
    got, ref = _import(kw, lambda m, r: m.GiantStepsKeyLoader(r), root, False)
    assert {it["mel"].shape[-1] for it in got.items} == {150}
    assert_same_dataset(got, ref, "float32")


@pytest.mark.parametrize("conv_dtype", ["float32", "bfloat16"])
def test_multi_scale_mel2_matches_jax(tmp_path, conv_dtype):
    root = giantsteps(tmp_path / "gs")
    kw = dict(BASE, multi_scale=True, cqt_conv_dtype=conv_dtype)
    got, ref = _import(kw, lambda m, r: m.GiantStepsKeyLoader(r), root, False)
    assert got[0]["mel2"].shape[0] == 12 * BASE["octaves"]
    assert_same_dataset(got, ref, conv_dtype, batch_size=4)


@pytest.mark.parametrize("kw", [
    {}, {"cqt_conv_dtype": "float32"}, {"octaves": 7, "frames": 0},
    {"only_semitones": True}])
def test_cache_path_matches_jax(kw):
    cfg = Config(**kw)
    jcfg = JaxConfig(**kw)
    for bpo in (36, 12):
        plain = cache_path("/d/a/song.wav", cfg, bpo)
        assert plain == jax_cache_path("/d/a/song.wav",
                                       jcfg.replace(use_pallas_cqt="off"), bpo)
        kernels = cache_path("/d/a/song.wav", cfg, bpo, cuda_kernels=True)
        assert kernels == jax_cache_path(
            "/d/a/song.wav", jcfg.replace(use_pallas_cqt="on"),
            bpo).replace("_pallas", "_cuda")
        assert kernels.endswith("_cuda.npz") and kernels != plain
    assert KeyDataset(False, cfg, device="cpu").cache_path(
        "x.mp3", 36) == cache_path("x.mp3", cfg, 36)


def test_cache_round_trip(tmp_path, monkeypatch):
    """Features written by one import are read back unchanged by the next,
    with no CQT run; a sidecar of another geometry is not taken."""
    root = giantsteps(tmp_path / "gs")
    cfg = Config(**BASE, multi_scale=True)
    ds1 = KeyDataset(False, cfg, blacklist_path="", device="cpu")
    ds1.import_data(loaders.GiantStepsKeyLoader(root), progress=False)
    for it in ds1.items:
        assert os.path.exists(cache_path(it["file"], cfg, 36))
        assert os.path.exists(cache_path(it["file"], cfg, 12))
    ds2 = KeyDataset(False, cfg, blacklist_path="", device="cpu")
    monkeypatch.setattr(ds2, "_features", lambda *a: pytest.fail("CQT ran"))
    ds2.import_data(loaders.GiantStepsKeyLoader(root), progress=False)
    for a, b in zip(ds1.items, ds2.items):
        assert a["file"] == b["file"]
        np.testing.assert_array_equal(a["mel"], b["mel"])
        np.testing.assert_array_equal(a["mel2"], b["mel2"])
    ds3 = KeyDataset(False, cfg.replace(octaves=3), blacklist_path="",
                     device="cpu")
    ds3.import_data(loaders.GiantStepsKeyLoader(root), progress=False)
    assert ds3[0]["mel"].shape[0] == 3 * 36


def test_blacklist(tmp_path):
    root = giantsteps(tmp_path / "gs", encodings=False)
    bl = tmp_path / "short_songs.txt"
    bl.write_text("s2.wav\n")
    ds = KeyDataset(False, Config(**BASE), blacklist_path=str(bl),
                    use_cache=False, device="cpu")
    ds.import_data(loaders.GiantStepsKeyLoader(root), progress=False)
    assert len(ds) == 4 and all("s2" not in it["file"] for it in ds.items)
    packaged = KeyDataset(False, Config(), device="cpu")
    ref = JaxDataset(False, JaxConfig(), use_cache=False)
    assert packaged.blacklist == ref.blacklist and len(ref.blacklist) == 11
    assert os.path.basename(PACKAGED_BLACKLIST) == "short_songs.txt"
    with pytest.raises(FileNotFoundError, match="blacklist"):
        KeyDataset(False, Config(), blacklist_path=str(tmp_path / "gone"),
                   device="cpu")


def test_kernels_on_the_cpu_refused():
    """use_pallas_cqt="on" asks for the CUDA kernels, which have no CPU
    version to run in their place."""
    with pytest.raises(ValueError, match="CUDA"):
        KeyDataset(False, Config(use_pallas_cqt="on"), device="cpu")
    assert not KeyDataset(False, Config(), device="cpu").use_kernels
    assert torch.device("cpu") == KeyDataset(False, Config(),
                                             device="cpu").device
