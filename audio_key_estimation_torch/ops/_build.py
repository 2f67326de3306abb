"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

nvcc compiles every source in `audio_key_estimation_torch/csrc/` for
Hopper (sm_90a), one process per source, all started together, and links
the objects into one shared library with a plain C interface, loaded
with ctypes — no PyTorch headers, so the build takes seconds. The library
lands in `audio_key_estimation_torch/_build/` (git-ignored) under a name
that hashes the sources and flags, so an edited source always rebuilds.
Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int16: 2}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "akt_cascade_pad": [_P, _I, _LL, _I, _I, _P, _I, _LL, _I, _I, _I, _I,
                        _P, _P],
    "akt_octave_response": [_P, _I, _LL, _P, _I, _P, _P, _I, _I, _P, _LL,
                            _I, _I, _P],
    "akt_octave_response_stage": [_P, _I, _LL, _P, _I, _P, _P, _I, _I, _P,
                                  _I, _I, _P],
    "akt_conv7": [_P, _P, _P, _P, _I, _I, _I, _P],
    "akt_window_copy": [_P, _LL, _I, _I, _P, _I, _I, _I, _I, _I, _I, _P,
                        _P],
    "akt_launch_probe": [_P, _P, _I, _I, _P],
    "akt_transpose_pad": [_P, _I, _LL, _I, _I, _I, _I, _P, _P],
    "akt_probe_primitive": [_I, _P, _P, _P],
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from csrc/ at first use")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libakt_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/ into the shared library unless it is already built;
    the compiler's report (registers, spills) goes beside it as .log."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [tmp.with_name(f"{tmp.name}.{p.stem}.o") for p in srcs]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o),
                               str(p)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for p, o in zip(srcs, objs)]
    report, failed = [], []
    for p, proc in zip(srcs, procs):
        out = proc.communicate()[0]
        report.append(f"== {p.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{p.name} ({proc.returncode}):\n{out}")
    if not failed:
        res = subprocess.run([_nvcc(), "-shared", "-o", str(tmp),
                              *map(str, objs)], capture_output=True,
                             text=True)
        report.append(f"== link\n{res.stdout}{res.stderr}")
        if res.returncode != 0:
            failed.append(f"link ({res.returncode}):\n{res.stderr}")
    for o in objs:
        o.unlink(missing_ok=True)
    so.with_suffix(".log").write_text("".join(report))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.akt_error_string.argtypes = [ctypes.c_int]
    lib.akt_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a C entry point reports a launch error."""
    if rc != 0:
        raise RuntimeError(
            f"{what}: CUDA launch failed ({rc}): "
            f"{lib.akt_error_string(rc).decode()}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
