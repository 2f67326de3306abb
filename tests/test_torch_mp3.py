"""PyTorch port: MP3 decode against the JAX package's, bit for bit.

The streams are tests/mp3_builder.py's, as tests/test_mp3.py and
tests/test_mp3_lsf.py build them for their native-against-numpy checks
(MPEG-1 at 32/44.1/48 kHz with long, short and mixed blocks, every stereo
mode, scfsi and the bit reservoir; LSF at every MPEG-2/2.5 rate), plus
start/stop and long/short transition blocks. The port's numpy decoder
must give the JAX decoder's PCM, its C++ decoder the numpy decoder's
channel 0, its decode chain (C++ -> numpy -> external transcode) the JAX
package's results and errors.
"""

import functools
import os
import shutil
import sys
import textwrap

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

import mp3_builder as B  # noqa: E402
from test_mp3 import _format_surface_streams, _pairs  # noqa: E402
from test_mp3_lsf import _lsf_surface_streams  # noqa: E402

from audio_key_estimation_tpu.data import audio_io as jax_io  # noqa: E402
from audio_key_estimation_tpu.data import mp3 as jax_mp3  # noqa: E402

from audio_key_estimation_torch.data import audio_io, mp3  # noqa: E402


def _block_streams():
    """Start and stop blocks, and a long -> start -> short -> stop -> long
    sequence across granules."""
    rng = np.random.default_rng(4)
    out = {}
    for bt in (1, 3):
        g = B.Granule(big_values=40, big_pairs=_pairs(rng, 40, 7),
                      window_switching=True, block_type=bt,
                      table_select=(10, 10, 10), global_gain=190)
        out[f"block_type{bt}"] = B.build_stream([B.build_frame([g, g])] * 3)
        out[f"lsf_block_type{bt}"] = B.build_stream(
            [B.build_frame_lsf(g)] * 3)
    gr = {bt: B.Granule(big_values=30, big_pairs=_pairs(rng, 30, 7),
                        window_switching=bt > 0, block_type=bt,
                        table_select=(10, 10, 10), global_gain=190)
          for bt in (0, 1, 2, 3)}
    out["transition"] = B.build_stream(
        [B.build_frame([gr[0], gr[1]]), B.build_frame([gr[2], gr[2]]),
         B.build_frame([gr[3], gr[0]])])
    return out


@functools.lru_cache(maxsize=None)
def streams(family: str) -> dict:
    return {"mpeg1": _format_surface_streams, "lsf": _lsf_surface_streams,
            "blocks": _block_streams}[family]()


FAMILIES = ["mpeg1", "lsf", "blocks"]


@pytest.mark.parametrize("family", FAMILIES)
def test_numpy_decoder_bitexact_vs_jax(family):
    for name, data in streams(family).items():
        pcm, sr = mp3.decode_mp3_bytes(data)
        ref, ref_sr = jax_mp3.decode_mp3_bytes(data)
        assert sr == ref_sr and pcm.dtype == ref.dtype, name
        np.testing.assert_array_equal(pcm, ref, err_msg=name)


@pytest.mark.parametrize("family", FAMILIES)
def test_native_decoder_bitexact_vs_numpy(tmp_path, family):
    """The port's C++ decoder gives its numpy decoder's channel 0, and
    decode_audio the JAX package's decode_audio, raw either way."""
    for i, (name, data) in enumerate(streams(family).items()):
        p = str(tmp_path / f"{i}.mp3")
        with open(p, "wb") as f:
            f.write(data)
        pcm, sr = mp3.decode_mp3_bytes(data)
        nat, nat_sr = audio_io._decode_mp3_native(p)
        assert nat_sr == sr, name
        np.testing.assert_array_equal(nat, pcm[:, 0].astype(np.float32),
                                      err_msg=name)
        for raw in (False, True):
            got, got_sr = audio_io.decode_audio(p, raw=raw)
            ref, ref_sr = jax_io.decode_audio(p, raw=raw)
            assert got_sr == ref_sr == sr and got.dtype == ref.dtype, name
            np.testing.assert_array_equal(got, ref, err_msg=name)


BAD_STREAMS = {
    "no_frames": bytes(1000),
    # valid LSF headers whose frame length never lands on the next sync
    "lone_headers": (bytes([0xFF, 0xF2, 0x90, 0x00]) + bytes(400)) * 3,
    # version bits 01 are reserved
    "reserved_version": (bytes([0xFF, 0xEB, 0x90, 0x00]) + bytes(400)) * 3,
}


@pytest.mark.parametrize("name", list(BAD_STREAMS))
def test_mp3_errors_match_jax(name):
    data = BAD_STREAMS[name]
    with pytest.raises(jax_mp3.Mp3Error) as ref:
        jax_mp3.decode_mp3_bytes(data)
    with pytest.raises(mp3.Mp3Error) as got:
        mp3.decode_mp3_bytes(data)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("sr", [44100, 16000])
def test_decode_audio_mp3_without_external_tools(monkeypatch, tmp_path, sr):
    """MPEG-1 and MPEG-2 files decode in-tree with ffmpeg and mpg123 off
    PATH, as the JAX package's do; a stream every decoder refuses raises
    the same error from decode_audio and from decode_many's pool."""
    monkeypatch.setattr(shutil, "which", lambda name: None)
    rng = np.random.default_rng(12)
    g = B.Granule(big_values=30, big_pairs=_pairs(rng, 30, 7),
                  table_select=(10, 10, 10), global_gain=190)
    frame = (B.build_frame([g, g]) if sr == 44100
             else B.build_frame_lsf(g, sr=sr))
    p = str(tmp_path / "clip.mp3")
    with open(p, "wb") as f:
        f.write(B.build_stream([frame] * 4))
    got, got_sr = audio_io.decode_audio(p)
    ref, ref_sr = jax_io.decode_audio(p)
    assert got_sr == ref_sr == sr and got.dtype == np.float32
    assert got.shape == (4 * (1152 if sr == 44100 else 576),)
    np.testing.assert_array_equal(got, ref)
    bad = str(tmp_path / "bad.mp3")
    with open(bad, "wb") as f:
        f.write(BAD_STREAMS["lone_headers"])
    for fn in (audio_io.decode_audio,
               lambda q: list(audio_io.decode_many([p, q]))):
        with pytest.raises(audio_io.AudioDecodeError,
                           match="no mp3 decoder available"):
            fn(bad)
    with pytest.raises(jax_io.AudioDecodeError,
                       match="no mp3 decoder available"):
        jax_io.decode_audio(bad)


def test_refused_mp3_goes_to_the_transcoder(monkeypatch, tmp_path, rng):
    """A stream both in-tree decoders refuse is transcoded by the external
    tool found on PATH (here a stand-in `ffmpeg` that writes a fixed
    WAV), in the port as in the JAX package."""
    wav = str(tmp_path / "transcoded.wav")
    audio_io.write_wav(wav, rng.uniform(-0.5, 0.5, 999), 22050)
    tool = tmp_path / "ffmpeg"
    tool.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import shutil, sys
        shutil.copyfile({wav!r}, sys.argv[-1])
        """))
    tool.chmod(0o755)
    monkeypatch.setattr(shutil, "which", lambda name: (
        str(tool) if name == "ffmpeg" else None))
    bad = str(tmp_path / "bad.mp3")
    with open(bad, "wb") as f:
        f.write(BAD_STREAMS["lone_headers"])
    for raw in (False, True):
        got, sr = audio_io.decode_audio(bad, raw=raw)
        ref, ref_sr = jax_io.decode_audio(bad, raw=raw)
        assert sr == ref_sr == 22050 and got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    got = list(audio_io.decode_many([bad, wav]))
    np.testing.assert_array_equal(got[0][0], got[1][0])


@pytest.mark.parametrize("raw", [False, True], ids=["pool", "threads"])
def test_decode_many_mixed_wav_mp3(tmp_path, raw):
    """decode_many dispatches WAV and MPEG-1/LSF MP3 by extension and
    yields the JAX package's results in input order."""
    mp3s = []
    for name in ("fuzz0", "ms"):
        p = str(tmp_path / f"{name}.mp3")
        with open(p, "wb") as f:
            f.write(streams("mpeg1")[name])
        mp3s.append(p)
    lsf = str(tmp_path / "lsf.mp3")
    with open(lsf, "wb") as f:
        f.write(streams("lsf")["sr8000"])
    wav = str(tmp_path / "b.wav")
    audio_io.write_wav(wav, np.sin(np.linspace(0, 80, 2000)) * 0.6, 44100)
    paths = [mp3s[0], wav, lsf, mp3s[1], mp3s[0]]
    got = list(audio_io.decode_many(paths, workers=2, raw=raw))
    ref = list(jax_io.decode_many(paths, workers=2, raw=raw))
    assert [sr for _, sr in got] == [sr for _, sr in ref] \
        == [44100, 44100, 8000, 44100, 44100]
    for (x, _), (y, _) in zip(got, ref):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
