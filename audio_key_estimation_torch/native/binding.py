"""ctypes bindings for the port's host audio library (native/*.cpp).

The C++ decode runtime — WAV decode, the MPEG-1/2/2.5 Layer III decoder,
the DecodePool worker threads and the one-call PCM16 batch ingest — is
carried here as byte copies of the JAX package's `native/` sources
(tests/test_torch_imports.py pins them). `load_library()` builds them at
first use with the host C++ compiler (the flags of that package's
Makefile) into `audio_key_estimation_torch/_build/` (git-ignored), under a
name that hashes the sources and the flags, and loads the result. A build
or load that fails raises: the numpy decoders behind it are ~40x slower,
so no caller drops to them without being told. The C ABI and ctypes keep
the binding free of any build dependency beyond the compiler.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"
SOURCES = ("akx_native.cpp", "akx_mp3.cpp", "akx_decoded.h",
           "akx_mp3_tables.h")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared")
# decode threads (decode_many's pool) may all ask for the library at once
_LOAD_LOCK = threading.Lock()


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.akx_decode_wav.restype = ctypes.c_void_p
    lib.akx_decode_wav.argtypes = [ctypes.c_char_p]
    lib.akx_decode_mp3.restype = ctypes.c_void_p
    lib.akx_decode_mp3.argtypes = [ctypes.c_char_p]
    lib.akx_samples.restype = ctypes.POINTER(ctypes.c_float)
    lib.akx_samples.argtypes = [ctypes.c_void_p]
    lib.akx_num_samples.restype = ctypes.c_int64
    lib.akx_num_samples.argtypes = [ctypes.c_void_p]
    lib.akx_sample_rate.restype = ctypes.c_int
    lib.akx_sample_rate.argtypes = [ctypes.c_void_p]
    lib.akx_error.restype = ctypes.c_char_p
    lib.akx_error.argtypes = [ctypes.c_void_p]
    lib.akx_free.argtypes = [ctypes.c_void_p]

    lib.akx_pool_create.restype = ctypes.c_void_p
    lib.akx_pool_create.argtypes = [ctypes.c_int]
    lib.akx_pool_destroy.argtypes = [ctypes.c_void_p]
    lib.akx_pool_submit.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_char_p]
    lib.akx_pool_poll.restype = ctypes.c_void_p
    lib.akx_pool_poll.argtypes = [ctypes.c_void_p]
    lib.akx_result_id.restype = ctypes.c_int64
    lib.akx_result_id.argtypes = [ctypes.c_void_p]
    lib.akx_result_ok.restype = ctypes.c_int
    lib.akx_result_ok.argtypes = [ctypes.c_void_p]
    lib.akx_result_samples.restype = ctypes.POINTER(ctypes.c_float)
    lib.akx_result_samples.argtypes = [ctypes.c_void_p]
    lib.akx_result_num_samples.restype = ctypes.c_int64
    lib.akx_result_num_samples.argtypes = [ctypes.c_void_p]
    lib.akx_result_sample_rate.restype = ctypes.c_int
    lib.akx_result_sample_rate.argtypes = [ctypes.c_void_p]
    lib.akx_result_error.restype = ctypes.c_char_p
    lib.akx_result_error.argtypes = [ctypes.c_void_p]
    lib.akx_result_free.argtypes = [ctypes.c_void_p]

    lib.akx_ingest_batch.restype = ctypes.c_int64
    lib.akx_ingest_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int16), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8)]
    return lib


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no host C++ compiler (c++ / g++, or set CXX): "
                           "the port's audio library is built from "
                           "native/*.cpp at first use")
    return cxx


def build_command(cxx: str, out: Path) -> list[str]:
    """The Makefile's one compile-and-link line."""
    return [cxx, *CXX_FLAGS, "-o", str(out),
            *(str(_DIR / s) for s in SOURCES if s.endswith(".cpp"))]


def library_path() -> Path:
    """The library's path, named by a hash of the sources and flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for s in SOURCES:
        h.update(s.encode())
        h.update((_DIR / s).read_bytes())
    return BUILD_DIR / f"libakx_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless this hash is already built. Concurrent
    builders (test workers) each write a private temporary file and
    rename it into place, so a reader never sees a partial library."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    res = subprocess.run(build_command(_cxx(), tmp), capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"audio library build failed "
                           f"({res.returncode}):\n{res.stderr}")
    os.replace(tmp, so)
    return so


def load_library() -> ctypes.CDLL:
    """The built and declared library; raises if it cannot be built or
    loaded. Safe to call from several threads: one builds, the others
    wait for it."""
    with _LOAD_LOCK:
        return _load()


@functools.lru_cache(maxsize=1)
def _load() -> ctypes.CDLL:
    return _declare(ctypes.CDLL(str(build())))
