"""PyTorch port: WAV decode, decode_many and ingest_batch against the JAX
package's `data/audio_io.py`, bit for bit.

Every WAV encoding the readers take (PCM u8/s16/s24/s32, float32/64,
stereo, WAVE_FORMAT_EXTENSIBLE) is written from one seeded signal; the
port's decode must return the same samples, dtype and rate as the JAX
package's, with `raw` both ways, and its C++ reader the same as its numpy
reader.
"""

import struct

import numpy as np
import pytest

from audio_key_estimation_tpu.data import audio_io as jax_io

from audio_key_estimation_torch.data import audio_io

SR = 8000
# (format tag, bits, channels, extensible) per encoding
ENCODINGS = {
    "u8": (1, 8, 1, False), "s16": (1, 16, 1, False),
    "s24": (1, 24, 1, False), "s32": (1, 32, 1, False),
    "f32": (3, 32, 1, False), "f64": (3, 64, 1, False),
    "s16_stereo": (1, 16, 2, False), "s24_stereo": (1, 24, 2, False),
    "f32_stereo": (3, 32, 2, False), "s16_ext": (1, 16, 1, True),
    "f32_ext": (3, 32, 2, True),
}


def _samples(rng, n, channels, fmt, bits) -> bytes:
    """Interleaved little-endian samples of a seeded signal."""
    x = rng.uniform(-0.9, 0.9, (n, channels))
    if fmt == 3:
        return x.astype("<f4" if bits == 32 else "<f8").tobytes()
    if bits == 8:
        return np.round(x * 127 + 128).astype("u1").tobytes()
    if bits == 24:
        v = np.round(x * (2 ** 23 - 1)).astype("<i4").reshape(-1)
        return v.view("u1").reshape(-1, 4)[:, :3].tobytes()
    dt = "<i2" if bits == 16 else "<i4"
    return np.round(x * (2 ** (bits - 1) - 1)).astype(dt).tobytes()


def write_encoded(path, rng, enc: str, n: int = 1501) -> str:
    fmt, bits, ch, ext = ENCODINGS[enc]
    data = _samples(rng, n, ch, fmt, bits)
    align = ch * bits // 8
    head = struct.pack("<HHIIHH", 0xFFFE if ext else fmt, ch, SR,
                       SR * align, align, bits)
    if ext:   # cbSize, valid bits, channel mask, sub-format GUID
        head += struct.pack("<HHIH", 22, bits, 0, fmt) + bytes(14)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(head)) + head
            + b"LIST" + struct.pack("<I", 3) + b"abc\x00"   # odd chunk
            + b"data" + struct.pack("<I", len(data)) + data)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    return str(path)


def _equal(got, ref):
    (x, sr), (y, sr_ref) = got, ref
    assert sr == sr_ref == SR
    assert x.dtype == y.dtype
    np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("raw", [False, True], ids=["float", "raw"])
@pytest.mark.parametrize("enc", list(ENCODINGS))
def test_decode_audio_matches_jax(tmp_path, rng, enc, raw):
    p = write_encoded(tmp_path / f"{enc}.wav", rng, enc)
    got = audio_io.decode_audio(p, raw=raw)
    _equal(got, jax_io.decode_audio(p, raw=raw))
    pcm16 = ENCODINGS[enc][:2] == (1, 16)
    assert got[0].dtype == (np.int16 if raw and pcm16 else np.float32)


@pytest.mark.parametrize("enc", list(ENCODINGS))
def test_native_reader_matches_numpy_reader(tmp_path, rng, enc):
    p = write_encoded(tmp_path / f"{enc}.wav", rng, enc)
    ref = jax_io._decode_wav_numpy(p)
    _equal(audio_io._decode_wav_native(p), ref)
    _equal(audio_io._decode_wav_numpy(p), ref)


def test_unsupported_encoding_raises(tmp_path, rng):
    """An encoding neither reader takes (A-law) raises in both, and in
    decode_audio and decode_many, as the JAX numpy reader and decode_many
    raise. (The C++ reader leaves zeros behind with its error; the port
    reads the error, where the JAX package's one-file path returns the
    zeros.)"""
    p = write_encoded(tmp_path / "s16.wav", rng, "s16")
    raw = bytearray(open(p, "rb").read())
    raw[20:22] = struct.pack("<H", 6)
    open(p, "wb").write(bytes(raw))
    for fn in (audio_io._decode_wav_numpy, audio_io._decode_wav_native,
               audio_io.decode_audio):
        with pytest.raises(audio_io.AudioDecodeError, match="fmt=6"):
            fn(p)
    with pytest.raises(audio_io.AudioDecodeError, match="fmt=6"):
        list(audio_io.decode_many([p]))
    for fn in (jax_io._decode_wav_numpy,
               lambda q: list(jax_io.decode_many([q]))):
        with pytest.raises(jax_io.AudioDecodeError, match="fmt=6"):
            fn(p)


def _mixed(tmp_path, rng, n_files=7):
    encs = list(ENCODINGS)
    return [write_encoded(tmp_path / f"m{i}.wav", rng, encs[i % len(encs)],
                          n=400 + 97 * i) for i in range(n_files)]


@pytest.mark.parametrize("raw", [False, True], ids=["pool", "threads"])
def test_decode_many_matches_jax_in_order(tmp_path, rng, raw):
    """raw=False runs the C++ DecodePool, raw=True the Python thread pool;
    both yield in input order what decode_audio gives per file."""
    paths = _mixed(tmp_path, rng)
    got = list(audio_io.decode_many(paths, workers=3, raw=raw))
    ref = list(jax_io.decode_many(paths, workers=3, raw=raw))
    assert len(got) == len(ref) == len(paths)
    for p, g, r in zip(paths, got, ref):
        _equal(g, r)
        _equal(g, audio_io.decode_audio(p, raw=raw))


@pytest.mark.parametrize("raw", [False, True], ids=["pool", "threads"])
def test_decode_many_raises_on_bad_file(tmp_path, rng, raw):
    good = write_encoded(tmp_path / "ok.wav", rng, "s16")
    bad = str(tmp_path / "nope.wav")
    with open(bad, "wb") as f:
        f.write(b"not a wav at all")
    with pytest.raises(audio_io.AudioDecodeError):
        list(audio_io.decode_many([good, bad, good], raw=raw))


def _pcm16_files(tmp_path, rng, lengths):
    paths = []
    for i, n in enumerate(lengths):
        p = str(tmp_path / f"ib{i}.wav")
        audio_io.write_wav(p, rng.uniform(-0.9, 0.9, n), SR)
        paths.append(p)
    return paths


def _same_ingest(got, ref):
    (b, lens, rates), (rb, rlens, rrates) = got, ref
    assert b.dtype == rb.dtype
    np.testing.assert_array_equal(b, rb)
    np.testing.assert_array_equal(lens, rlens)
    assert rates == rrates


@pytest.mark.parametrize("path", ["native", "readinto"])
def test_ingest_batch_matches_jax(tmp_path, rng, monkeypatch, path):
    """The one-call C ingest and the Python readinto path each give the
    JAX package's batch, lengths and rates: short rows zero-tailed, long
    files trimmed, unused rows zero, into a reused `out` full of stale
    values."""
    paths = _pcm16_files(tmp_path, rng, (500, 637, 1200, 774))
    pad = 800
    ref = jax_io.ingest_batch(paths, pad, n_rows=6)
    if path == "readinto":
        monkeypatch.setattr(audio_io, "_ingest_native",
                            lambda *a: None)
    out = np.full((6, pad), 7, np.int16)
    got = audio_io.ingest_batch(paths, pad, n_rows=6, out=out)
    assert got[0] is out
    _same_ingest(got, ref)
    assert [int(n) for n in got[1]] == [500, 637, 800, 774]
    decoded = list(jax_io.decode_many(paths, raw=True))
    np.testing.assert_array_equal(
        got[0], jax_io.pack_batch((w[:pad] for w, _ in decoded), pad,
                                  n_rows=6))


def test_ingest_batch_non_pcm16_falls_back(tmp_path, rng):
    """A stereo or float member routes the whole batch through
    decode_many + pack_batch: a float32 batch, `out` ignored."""
    paths = _pcm16_files(tmp_path, rng, (400, 300))
    paths += [write_encoded(tmp_path / "st.wav", rng, "s16_stereo", 350),
              write_encoded(tmp_path / "f.wav", rng, "f32", 500)]
    out = np.zeros((4, 450), np.int16)
    got = audio_io.ingest_batch(paths, 450, out=out)
    assert got[0].dtype == np.float32 and got[0] is not out
    _same_ingest(got, jax_io.ingest_batch(paths, 450))


def test_ingest_batch_rejects_bad_out_and_rows(tmp_path, rng):
    paths = _pcm16_files(tmp_path, rng, (300, 900))
    with pytest.raises(ValueError, match="out must be"):
        audio_io.ingest_batch(paths, 600, n_rows=3,
                              out=np.zeros((3, 600), np.float32))
    with pytest.raises(ValueError, match="n_rows"):
        audio_io.ingest_batch(paths, 600, n_rows=1)


def test_host_library_builds_once_under_concurrent_first_use(
        tmp_path, monkeypatch):
    """Decode threads may all ask for the host library before it exists:
    one builds it, every caller gets the same library, no temporary file
    is left behind."""
    import threading

    from audio_key_estimation_torch.native import binding
    monkeypatch.setattr(binding, "BUILD_DIR", tmp_path / "_build")
    binding._load.cache_clear()
    results, errors = [], []
    barrier = threading.Barrier(16)

    def first_use():
        try:
            barrier.wait(timeout=30)
            results.append(binding.load_library())
        except Exception as e:        # re-raised below
            errors.append(e)
    threads = [threading.Thread(target=first_use) for _ in range(16)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        assert len(results) == 16 and all(r is results[0] for r in results)
        assert [p.name for p in (tmp_path / "_build").iterdir()] == [
            binding.library_path().name]
    finally:
        binding._load.cache_clear()
