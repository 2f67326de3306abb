"""PCM16 WAV decode and batch packing — the serving path's host ingest.

The PCM16 subset of the JAX package's `data/audio_io.py` (that package's
`data/__init__` imports JAX, so the functions are carried here; tests pin
them to the originals). Raw PCM16 stays int16 end to end: the 1/32768
normalization runs on the device inside the CQT (ops/cqt.py). Other
encodings — MP3, float or 8/24/32-bit WAV — raise NotImplementedError
until the port's decode item lands (ROADMAP.md, port queue item 3).
"""

from __future__ import annotations

import concurrent.futures as futures
import mmap
import os
import struct

import numpy as np

_NOT_PORTED = ("only PCM16 WAV decode is ported so far; MP3 and float WAV "
               "decode are ROADMAP.md port queue item 3")


class AudioDecodeError(RuntimeError):
    pass


def _wav_layout(path: str):
    """RIFF chunk walk using reads+seeks only (no data-chunk I/O).

    Returns (fmt, channels, bits, rate, data_off, data_len) or raises
    AudioDecodeError for a non-RIFF file / missing chunks.
    """
    with open(path, "rb") as f:
        head = f.read(12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise AudioDecodeError(f"{path}: not a RIFF/WAVE file")
        size = os.fstat(f.fileno()).st_size
        fmt = channels = bits = rate = 0
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid = hdr[:4]
            clen = struct.unpack("<I", hdr[4:])[0]
            pos = f.tell()
            if cid == b"fmt " and clen >= 16:
                body = f.read(min(clen, 64))
                fmt, channels, rate = struct.unpack_from("<HHI", body, 0)
                bits = struct.unpack_from("<H", body, 14)[0]
                if fmt == 0xFFFE and clen >= 40:
                    fmt = struct.unpack_from("<H", body, 24)[0]
            elif cid == b"data":
                data = (pos, min(clen, size - pos))
            f.seek(pos + clen + (clen & 1))
        if data is None or channels == 0:
            raise AudioDecodeError(f"{path}: missing fmt/data chunk")
        return fmt, channels, bits, rate, data[0], data[1]


def _decode_wav_raw(path: str):
    """PCM16 fast path: (int16 channel-0 samples, sr) with no sample
    conversion — a header parse plus, for mono, a zero-copy view over a
    memory map. Returns None for non-PCM16 encodings."""
    fmt, channels, bits, rate, off, dlen = _wav_layout(path)
    if fmt != 1 or bits != 16:
        return None
    with open(path, "rb") as f:
        try:
            buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except (ValueError, OSError):   # empty or unmappable file
            buf = f.read()
    x = np.frombuffer(buf, "<i2", count=(dlen // (2 * channels)) * channels,
                      offset=off)
    if channels > 1:
        x = np.ascontiguousarray(x[::channels])
    return x, rate


def decode_audio(path: str):
    """(int16 samples of channel 0, sample_rate) for a PCM16 WAV file —
    the JAX package's decode_audio(raw=True); the device normalizes."""
    if os.path.splitext(path)[1].lower() != ".wav":
        raise NotImplementedError(f"{path}: {_NOT_PORTED}")
    out = _decode_wav_raw(path)
    if out is None:
        raise NotImplementedError(f"{path}: {_NOT_PORTED}")
    return out


def decode_many(paths, workers: int = 8):
    """Decode files on a thread pool (file reads release the GIL),
    yielding (int16 samples, sr) in input order."""
    paths = list(paths)
    with futures.ThreadPoolExecutor(
            max_workers=max(1, min(workers, len(paths) or 1))) as tp:
        futs = [tp.submit(decode_audio, p) for p in paths]
        for f in futs:
            yield f.result()


def pack_batch(waves, pad_len: int, n_rows: int | None = None) -> np.ndarray:
    """Zero-padded (n_rows, pad_len) signal batch for the device front-end.

    Stays int16 when every waveform is raw PCM16 (half the H2D bytes; the
    CQT normalizes on device), otherwise normalized float32 with any
    int16 members converted host-side.
    """
    waves = list(waves)
    n = n_rows if n_rows is not None else len(waves)
    if all(w.dtype == np.int16 for w in waves):
        batch = np.zeros((n, pad_len), np.int16)
        for i, w in enumerate(waves):
            batch[i, :len(w)] = w
        return batch
    batch = np.zeros((n, pad_len), np.float32)
    for i, w in enumerate(waves):
        if w.dtype == np.int16:
            batch[i, :len(w)] = w.astype(np.float32) / 32768.0
        else:
            batch[i, :len(w)] = w
    return batch


def write_wav(path: str, samples: np.ndarray, sr: int) -> None:
    """Write mono PCM16 (test fixtures, chip_smoke.py's corpus)."""
    x = np.clip(np.asarray(samples, np.float32), -1.0, 1.0)
    pcm = np.round(x * 32767.0).astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16))
        f.write(b"data" + struct.pack("<I", len(pcm)) + pcm)
