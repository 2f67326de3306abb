"""Build and load the port's CUDA kernels (csrc/) as `torch.ops.akt`.

Every kernel source `csrc/*.cu` has a plain C launcher and includes no
PyTorch header: nvcc compiles each for Hopper (sm_90a), one process per
source, in seconds. `csrc/bindings.cpp`, the one file that sees PyTorch's
(light) headers, defines an operator per launcher and registers its CUDA
implementation; the host C++ compiler builds it against the installed
torch, in parallel with nvcc. The objects are linked into one shared
library against torch's libraries (rpath to `torch/lib`) and loaded with
`torch.ops.load_library`. The library lands in
`audio_key_estimation_torch/_build/` (git-ignored) under a name that
hashes the sources, the flags, and the torch version and C++ ABI it was
built against, so an edited source or another torch always rebuilds.
Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

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
TORCH_LIBS = ("c10", "c10_cuda", "torch_cpu", "torch_cuda", "torch")
# bindings.cpp's standard: the one torch.utils.cpp_extension passes in
# torch 2.11 and 2.13. A torch whose headers need another fails that
# file's compile, and build() raises with the compiler's report.
HOST_STD = "-std=c++20"

# the dtypes the kernels read and write (csrc/common.cuh AktDtype)
KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.int16)


def cuda_home() -> str:
    return os.environ.get("CUDA_HOME") or "/usr/local/cuda"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home(), "bin",
                                                    "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from csrc/ at first use")


def _cxx() -> str:
    return shutil.which("c++") or shutil.which("g++") or "c++"


def host_flags() -> tuple[str, ...]:
    """Host C++ flags for bindings.cpp: C++20, torch's C++ ABI, its
    include directories (not the CUDA variant, which looks for a CUDA
    install itself) and the CUDA runtime headers c10/cuda includes."""
    import torch.utils.cpp_extension as ext
    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    incs = [*ext.include_paths(),
            os.path.join(cuda_home(), "include")]
    return (HOST_STD, "-O2", "-fPIC",
            f"-D_GLIBCXX_USE_CXX11_ABI={abi}", *(f"-I{p}" for p in incs))


def compile_command(src: Path, obj: Path, nvcc: str, cxx: str) -> list[str]:
    """nvcc for sm_90a for a .cu source, the host compiler for .cpp."""
    if src.suffix == ".cu":
        return [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
    return [cxx, *host_flags(), "-c", "-o", str(obj), str(src)]


def link_command(objs, so: Path, nvcc: str) -> list[str]:
    """Link through nvcc, which links its CUDA runtime statically,
    against torch's libraries, with an rpath to them."""
    lib = str(Path(torch.__file__).resolve().parent / "lib")
    return [nvcc, "-shared", "-o", str(so), *map(str, objs), f"-L{lib}",
            *(f"-l{name}" for name in TORCH_LIBS), "-Xlinker",
            f"-rpath={lib}"]


def sources() -> list[Path]:
    return sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cpp")])


def library_path() -> Path:
    """The library's path, named by a hash of everything it depends on."""
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *host_flags(), *TORCH_LIBS,
                                 torch.__version__)).encode())
    for p in sorted(CSRC.glob("*.c*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libakt_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/ into the shared library unless it is already built;
    the compilers' report (registers, spills) goes beside it as .log."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    nvcc, cxx = _nvcc(), _cxx()
    srcs = sources()
    objs = [tmp.with_name(f"{tmp.name}.{p.stem}.o") for p in srcs]
    procs = [subprocess.Popen(compile_command(p, o, nvcc, cxx),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for p, o in zip(srcs, objs)]
    report, failed = [], []
    for p, proc in zip(srcs, procs):
        out = proc.communicate()[0]
        report.append(f"== {p.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{p.name} ({proc.returncode}):\n{out}")
    if not failed:
        res = subprocess.run(link_command(objs, tmp, nvcc),
                             capture_output=True, text=True)
        report.append(f"== link\n{res.stdout}{res.stderr}")
        if res.returncode != 0:
            failed.append(f"link ({res.returncode}):\n{res.stderr}")
    for o in objs:
        o.unlink(missing_ok=True)
    so.with_suffix(".log").write_text("".join(report))
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=1)
def library():
    """torch.ops.akt, after the kernel library is built and loaded."""
    torch.ops.load_library(str(build()))
    return torch.ops.akt


@functools.cache
def op(name: str):
    """The operator overload torch.ops.akt.<name>.default, resolved once."""
    return getattr(library(), name).default


def registered_ops() -> list[str]:
    """The schemas of every akt operator the dispatcher knows."""
    return [str(torch._C._dispatch_find_schema_or_throw(n, "").schema())
            for n in sorted(torch._C._dispatch_get_all_op_names())
            if n.startswith("akt::")]
