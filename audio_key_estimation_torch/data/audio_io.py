"""Audio decode and batch ingest: the host side of serving and of dataset
preprocessing.

The port of the JAX package's `data/audio_io.py`, with the same decode
semantics on every input (tests pin them bit for bit):

  * WAV — PCM u8/s16/s24/s32 and float32/64, mono or multichannel,
    WAVE_FORMAT_EXTENSIBLE — decodes channel 0 in the port's C++ library
    (native/binding.py); `_decode_wav_numpy` is the plain reader it is
    held against;
  * MP3 — MPEG-1/2/2.5 Layer III decodes in the C++ library; a stream it
    refuses goes to the numpy decoder (data/mp3.py), and a stream that
    refuses too to an `ffmpeg`/`mpg123` transcode when one is on PATH;
  * raw=True keeps PCM16 WAV samples int16 (the 1/32768 normalization runs
    on the device inside the CQT, ops/cqt.py) and returns float32 for
    every other encoding; raw=False returns normalized float32 always
    (torchaudio.load semantics, channel 0).

`ingest_batch` reads a batch of mono PCM16 WAVs straight into a padded
int16 batch in one C call, and falls back to decode_many + pack_batch for
anything else.
"""

from __future__ import annotations

import concurrent.futures as futures
import ctypes
import mmap
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time
from contextlib import nullcontext

import numpy as np

from ..native.binding import load_library


class AudioDecodeError(RuntimeError):
    pass


def _decode_wav_native(path: str):
    """The C++ reader. A failed decode can leave samples behind (zeros
    for an unsupported encoding), so its error message decides."""
    lib = load_library()
    h = lib.akx_decode_wav(path.encode())
    try:
        n = lib.akx_num_samples(h)
        sr = lib.akx_sample_rate(h)
        err = lib.akx_error(h).decode()
        if n == 0 or sr == 0 or err:
            raise AudioDecodeError(f"{path}: {err or 'decode failed'}")
        buf = np.ctypeslib.as_array(lib.akx_samples(h), shape=(n,))
        return buf.copy(), sr
    finally:
        lib.akx_free(h)


def _decode_wav_numpy(path: str):
    """Minimal RIFF/WAVE parser (PCM u8/s16/s24/s32, float32/64), channel 0:
    the plain reader the C++ one is held against."""
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 44 or buf[:4] != b"RIFF" or buf[8:12] != b"WAVE":
        raise AudioDecodeError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = channels = bits = rate = 0
    data = None
    while pos + 8 <= len(buf):
        cid = buf[pos:pos + 4]
        clen = struct.unpack_from("<I", buf, pos + 4)[0]
        body = buf[pos + 8: pos + 8 + clen]
        if cid == b"fmt " and clen >= 16:
            fmt, channels, rate = struct.unpack_from("<HHI", body, 0)
            bits = struct.unpack_from("<H", body, 14)[0]
            if fmt == 0xFFFE and clen >= 40:
                fmt = struct.unpack_from("<H", body, 24)[0]
        elif cid == b"data":
            data = body
        pos += 8 + clen + (clen & 1)
    if data is None or channels == 0:
        raise AudioDecodeError(f"{path}: missing fmt/data chunk")
    if fmt == 1 and bits == 16:
        x = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
    elif fmt == 1 and bits == 32:
        x = np.frombuffer(data, "<i4").astype(np.float32) / 2147483648.0
    elif fmt == 1 and bits == 8:
        x = (np.frombuffer(data, "u1").astype(np.float32) - 128.0) / 128.0
    elif fmt == 1 and bits == 24:
        raw = np.frombuffer(data, "u1")
        raw = raw[: (len(raw) // 3) * 3].reshape(-1, 3).astype(np.uint32)
        v = (raw[:, 0] << 8 | raw[:, 1] << 16 | raw[:, 2] << 24).astype(np.int32) >> 8
        x = v.astype(np.float32) / 8388608.0
    elif fmt == 3 and bits == 32:
        x = np.frombuffer(data, "<f4").astype(np.float32)
    elif fmt == 3 and bits == 64:
        x = np.frombuffer(data, "<f8").astype(np.float32)
    else:
        raise AudioDecodeError(f"{path}: unsupported encoding fmt={fmt} bits={bits}")
    x = x[: (len(x) // channels) * channels].reshape(-1, channels)
    return np.ascontiguousarray(x[:, 0]), rate


def _decode_mp3_native(path: str):
    """The C++ decoder (native/akx_mp3.cpp, ~40x the numpy decoder).
    Returns None when it refuses the stream — an error, even after some
    frames decoded — so the fallback runs (the numpy decoder re-derives
    the precise error)."""
    lib = load_library()
    h = lib.akx_decode_mp3(path.encode())
    try:
        n = lib.akx_num_samples(h)
        sr = lib.akx_sample_rate(h)
        if n == 0 or sr == 0 or lib.akx_error(h):
            return None
        buf = np.ctypeslib.as_array(lib.akx_samples(h), shape=(n,))
        return buf.copy(), sr
    finally:
        lib.akx_free(h)


def _transcode_to_wav(path: str) -> str:
    for tool, args in (("ffmpeg", ["-y", "-i", path, "-ac", "1"]),
                       ("mpg123", ["-w"])):
        exe = shutil.which(tool)
        if exe:
            tmp = tempfile.NamedTemporaryFile(suffix=".wav", delete=False)
            tmp.close()
            if tool == "ffmpeg":
                cmd = [exe] + args + [tmp.name]
            else:
                cmd = [exe, "-w", tmp.name, path]
            r = subprocess.run(cmd, capture_output=True)
            if r.returncode == 0:
                return tmp.name
            os.unlink(tmp.name)
    raise AudioDecodeError(
        f"{path}: no mp3 decoder available (install ffmpeg or pre-convert "
        "the corpus to wav)")


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


def decode_audio(path: str, raw: bool = False):
    """(samples of channel 0, sample_rate).

    raw=False: samples are normalized float32. raw=True: PCM16 WAV files
    return int16 samples with the normalization deferred to the device;
    other encodings still return float32.
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == ".mp3":
        out = _decode_mp3_native(path)
        if out is not None:
            return out
        from .mp3 import Mp3Error, decode_mp3_file
        try:
            pcm, sr = decode_mp3_file(path)
            return np.ascontiguousarray(pcm[:, 0]), sr
        except Mp3Error:
            # damaged/non-conforming stream: external transcode fallback
            tmp = _transcode_to_wav(path)
            try:
                return decode_audio(tmp, raw=raw)
            finally:
                os.unlink(tmp)
    if raw:
        out = _decode_wav_raw(path)
        if out is not None:
            return out
    return _decode_wav_native(path)


def decode_many(paths, workers: int = 8, raw: bool = False):
    """Decode files concurrently, yielding (samples, sr) in input order.

    WAV and MP3 files run through the C++ DecodePool (worker threads, no
    GIL); other extensions, and MP3 streams the pool refuses (damaged or
    non-conforming: the numpy decoder / transcode chain of decode_audio),
    run on a Python thread pool.

    raw=True skips sample conversion for PCM16 files (int16 results; see
    decode_audio) — those are pure I/O, so they bypass the C++ pool and run
    on the Python pool (file reads release the GIL).
    """
    paths = list(paths)
    if raw:
        with futures.ThreadPoolExecutor(
                max_workers=max(1, min(workers, len(paths) or 1))) as tp:
            futs = [tp.submit(decode_audio, p, raw=True) for p in paths]
            for f in futs:
                yield f.result()
        return
    lib = load_library()
    native_exts = (".wav", ".mp3")
    ext = [os.path.splitext(p)[1].lower() for p in paths]
    results: dict = {}
    native_paths: dict = {}
    py_jobs: dict = {}
    # mp3 may bounce back from the native pool, so a Python pool is kept
    # warm whenever mp3 is in the batch; otherwise none is started (idle
    # threads compete with the C++ workers for cores on small hosts)
    needs_py = [p for p, e in zip(paths, ext)
                if e not in native_exts or e == ".mp3"]
    pool = lib.akx_pool_create(workers)
    with futures.ThreadPoolExecutor(
            max_workers=max(1, min(workers, len(needs_py)))) \
            if needs_py else nullcontext() as tpool:
        try:
            for i, p in enumerate(paths):
                if ext[i] in native_exts:
                    lib.akx_pool_submit(pool, i, p.encode())
                    native_paths[i] = p
                else:
                    py_jobs[i] = tpool.submit(decode_audio, p)
            pending_native = set(native_paths)
            next_i = 0
            while next_i < len(paths):
                progressed = False
                while pending_native:
                    r = lib.akx_pool_poll(pool)
                    if not r:
                        break
                    progressed = True
                    rid = lib.akx_result_id(r)
                    try:
                        if lib.akx_result_ok(r):
                            m = lib.akx_result_num_samples(r)
                            sr = lib.akx_result_sample_rate(r)
                            buf = np.ctypeslib.as_array(
                                lib.akx_result_samples(r), shape=(m,)).copy()
                            results[rid] = (buf, sr)
                        elif ext[rid] == ".mp3":
                            # damaged mp3: decode_audio re-derives the
                            # error and runs the transcode fallback chain
                            py_jobs[rid] = tpool.submit(
                                decode_audio, native_paths[rid])
                        else:
                            msg = (lib.akx_result_error(r) or b"").decode()
                            results[rid] = AudioDecodeError(
                                f"{native_paths[rid]}: {msg or 'decode failed'}")
                    finally:
                        lib.akx_result_free(r)
                    pending_native.discard(rid)
                for i, fut in list(py_jobs.items()):
                    if fut.done():
                        progressed = True
                        try:
                            results[i] = fut.result()
                        except Exception as e:  # re-raised in input order
                            results[i] = e
                        del py_jobs[i]
                while next_i < len(paths) and next_i in results:
                    progressed = True
                    out = results.pop(next_i)
                    next_i += 1
                    if isinstance(out, Exception):
                        raise out
                    yield out
                if not progressed:
                    time.sleep(0.002)
        finally:
            lib.akx_pool_destroy(pool)


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


def _int16_batch(out, n: int, pad_len: int) -> np.ndarray:
    """`out` checked as a reusable (n, pad_len) int16 batch, or a new one."""
    if out is None:
        return np.empty((n, pad_len), np.int16)
    if (out.shape != (n, pad_len) or out.dtype != np.int16
            or not out.flags.c_contiguous):
        raise ValueError(f"out must be C-contiguous int16 {(n, pad_len)}, "
                         f"got {out.dtype} {out.shape}")
    return out


def _ingest_native(paths, pad_len: int, workers: int, n: int, out):
    """One C call (akx_ingest_batch) header-parses and preads every file's
    PCM16 data chunk into its batch row, zero-filling the tails and the
    unused rows. (batch, lengths, rates), or None unless every file
    ingested clean."""
    batch = _int16_batch(out, n, pad_len)
    arr = (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])
    lengths = np.empty(len(paths), np.int64)
    rates = np.empty(len(paths), np.int32)
    ok = np.empty(len(paths), np.uint8)
    n_ok = load_library().akx_ingest_batch(
        arr, len(paths),
        batch.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        # pthreads contending for one core are pure scheduling overhead
        n, pad_len, workers if (os.cpu_count() or 1) > 1 else 1,
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        rates.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if n_ok != len(paths):
        return None
    return batch, lengths, [int(r) for r in rates]


def ingest_batch(paths, pad_len: int, workers: int = 8,
                 n_rows: int | None = None, out: np.ndarray | None = None):
    """Decode a batch of audio files straight into a zero-padded batch.

    When every file is a mono PCM16 WAV, one C call reads each data chunk
    into its row of the int16 batch (`_ingest_native`); if it refuses a
    file, each data chunk is ``readinto``-ed from Python into its row (on
    a thread pool on multi-core hosts, the GIL released). Pass ``out``
    ((n_rows, pad_len) int16, C-contiguous) to reuse a batch buffer
    across calls: rows are overwritten up to ``lengths[i]`` and
    zero-filled after it.

    Any other input (stereo, non-PCM16, mp3, big-endian hosts) falls back
    to decode_many + pack_batch, which keeps full decode semantics
    (float32 batch; ``out`` is ignored).

    Returns (batch, lengths, rates): batch is (n_rows, pad_len),
    lengths[i] the unpadded sample count of row i (trimmed to pad_len),
    rates[i] its sample rate.
    """
    paths = list(paths)
    if n_rows is not None and n_rows < len(paths):
        raise ValueError(
            f"n_rows={n_rows} < {len(paths)} files: the batch cannot hold "
            "every file (rows are per-file)")
    n = n_rows if n_rows is not None else len(paths)
    all_wav = all(os.path.splitext(p)[1].lower() == ".wav" for p in paths)
    if all_wav and paths and sys.byteorder == "little":
        got = _ingest_native(paths, pad_len, workers, n, out)
        if got is not None:
            return got

    layouts = []
    for p in paths:
        if os.path.splitext(p)[1].lower() != ".wav":
            layouts = None
            break
        try:
            lay = _wav_layout(p)
        except (AudioDecodeError, OSError):
            layouts = None
            break
        if lay[0] != 1 or lay[1] != 1 or lay[2] != 16:
            layouts = None
            break
        layouts.append(lay)
    if layouts is None or sys.byteorder != "little":
        decoded = list(decode_many(paths, workers=workers, raw=True))
        batch = pack_batch((w[:pad_len] for w, _ in decoded), pad_len,
                           n_rows=n_rows)
        lengths = np.array([min(len(w), pad_len) for w, _ in decoded],
                           np.int64)
        rates = [sr for _, sr in decoded]
        return batch, lengths, rates

    batch = _int16_batch(out, n, pad_len)
    for i in range(len(paths), n):
        batch[i] = 0                    # unused padding rows stay zero
    lengths = np.array([min(lay[5] // 2, pad_len) for lay in layouts],
                       np.int64)

    def _fill(i: int) -> None:
        off = layouts[i][4]
        m = int(lengths[i])
        done = 0
        if m > 0:
            with open(paths[i], "rb", buffering=0) as f:
                f.seek(off)
                view = memoryview(batch[i, :m]).cast("B")
                # raw readinto may legally return short; loop to EOF
                while done < 2 * m:
                    got = f.readinto(view[done:])
                    if not got:
                        break
                    done += got
        if done // 2 < pad_len:         # short read and/or the pad tail
            batch[i, done // 2:] = 0

    if (os.cpu_count() or 1) > 1 and workers > 1 and len(paths) > 1:
        with futures.ThreadPoolExecutor(
                max_workers=min(workers, len(paths))) as tp:
            list(tp.map(_fill, range(len(paths))))
    else:
        for i in range(len(paths)):
            _fill(i)
    return batch, lengths, [lay[3] for lay in layouts]


def write_wav(path: str, samples: np.ndarray, sr: int) -> None:
    """Write mono PCM16 (test fixtures, synthetic corpora)."""
    x = np.clip(np.asarray(samples, np.float32), -1.0, 1.0)
    pcm = np.round(x * 32767.0).astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16))
        f.write(b"data" + struct.pack("<I", len(pcm)) + pcm)
