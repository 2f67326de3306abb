"""PyTorch port: how the CUDA kernels are built and bound, checked off the card.

The kernels (audio_key_estimation_torch/csrc/*.cu) are compiled by nvcc
and bound to PyTorch's dispatcher as torch.ops.akt operators by
csrc/bindings.cpp, built by the host compiler against torch's headers
(ops/_build.py). Nothing here runs a compiler: the command lines are
pure functions of the sources and the installed torch, the operator
schemas are read from bindings.cpp as text, and every wrapper is shown
to refuse a tensor that is on neither the CPU nor a card without
reaching a plain version or the library. The kernels themselves are
held against their plain versions on the card by chip_smoke.py.
"""

import ast
import contextlib
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.utils.cpp_extension

from audio_key_estimation_torch.ops import _build
from audio_key_estimation_torch.ops import convstack_cuda as CS
from audio_key_estimation_torch.ops import cqt_cuda as K
from audio_key_estimation_torch.ops import pcstack_cuda as PS
from audio_key_estimation_torch.ops import probes_cuda as PC
from audio_key_estimation_torch.ops import resstack_cuda as RS
from audio_key_estimation_torch.scripts import probe_pallas_overhead

REPO = Path(__file__).resolve().parent.parent
OPS_DIR = REPO / "audio_key_estimation_torch" / "ops"
BINDINGS = _build.CSRC / "bindings.cpp"
TORCH_LIB = str(Path(torch.__file__).resolve().parent / "lib")


# ---------------------------------------------------------------------------
# compile and link command lines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src", _build.sources(), ids=lambda p: p.name)
def test_compile_command(src):
    """.cu sources go to nvcc for sm_90a without torch's headers; the
    bindings go to the host compiler with torch's headers, C++ standard
    and ABI, and the CUDA runtime headers."""
    cmd = _build.compile_command(src, Path("out.o"), "NVCC", "CXX")
    assert cmd[-4:] == ["-c", "-o", "out.o", str(src)]
    if src.suffix == ".cu":
        assert cmd[0] == "NVCC"
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert not any(a.startswith("-I") for a in cmd)
        return
    assert src.name == "bindings.cpp" and cmd[0] == "CXX"
    assert not any("sm_90" in a or "compute_90" in a for a in cmd)
    for inc in torch.utils.cpp_extension.include_paths():
        assert f"-I{inc}" in cmd
    assert f"-I{os.path.join(_build.cuda_home(), 'include')}" in cmd
    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    assert f"-D_GLIBCXX_USE_CXX11_ABI={abi}" in cmd
    assert "-fPIC" in cmd and "-std=c++20" in cmd


def test_link_command():
    """One shared library from every object, linked by nvcc against
    torch's libraries with an rpath to torch/lib."""
    objs = [Path("a.o"), Path("b.o")]
    cmd = _build.link_command(objs, Path("lib.so"), "NVCC")
    assert cmd[:4] == ["NVCC", "-shared", "-o", "lib.so"]
    assert cmd[4:6] == ["a.o", "b.o"]
    assert f"-L{TORCH_LIB}" in cmd
    for name in ("c10", "c10_cuda", "torch_cpu", "torch_cuda", "torch"):
        assert f"-l{name}" in cmd
    i = cmd.index("-Xlinker")
    assert cmd[i + 1] == f"-rpath={TORCH_LIB}"


def test_sources_cover_every_kernel_and_the_bindings():
    names = {p.name for p in _build.sources()}
    assert "bindings.cpp" in names
    assert {p.name for p in _build.CSRC.glob("*.cu")} <= names


# ---------------------------------------------------------------------------
# the library's name: a hash of everything it was built from
# ---------------------------------------------------------------------------

@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def test_library_path_is_stable(csrc_copy):
    assert _build.library_path() == _build.library_path()
    assert _build.library_path().parent == _build.BUILD_DIR


def test_library_path_follows_torch_version(csrc_copy, monkeypatch):
    before = _build.library_path()
    monkeypatch.setattr(torch, "__version__", torch.__version__ + ".other")
    assert _build.library_path() != before


def test_library_path_follows_cxx_abi(csrc_copy, monkeypatch):
    before = _build.library_path()
    monkeypatch.setattr(torch._C, "_GLIBCXX_USE_CXX11_ABI",
                        not torch._C._GLIBCXX_USE_CXX11_ABI)
    assert _build.library_path() != before


@pytest.mark.parametrize("name", ["bindings.cpp", "probe_launch.cu",
                                  "common.cuh"])
def test_library_path_follows_sources(csrc_copy, name):
    before = _build.library_path()
    with open(csrc_copy / name, "a") as f:
        f.write("\n// edited\n")
    assert _build.library_path() != before


# ---------------------------------------------------------------------------
# the operators: what the wrappers call is what bindings.cpp defines
# ---------------------------------------------------------------------------

def _block(text: str, head: str) -> str:
    """The body of `head { ... }` in text (braces balanced)."""
    i = text.index("{", text.index(head))
    depth = 0
    for j in range(i, len(text)):
        depth += {"{": 1, "}": -1}.get(text[j], 0)
        if depth == 0:
            return text[i + 1:j]
    raise AssertionError(f"unbalanced {head}")


def _top_level_args(args: str) -> list[str]:
    out, depth, cur = [], 0, ""
    for ch in args:
        depth += {"(": 1, "[": 1, ")": -1, "]": -1}.get(ch, 0)
        if ch == "," and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            cur += ch
    return [a for a in (*out, cur.strip()) if a]


def defined_schemas() -> dict:
    """{op name: [argument declarations]} from TORCH_LIBRARY(akt, m)."""
    block = _block(BINDINGS.read_text(), "TORCH_LIBRARY(akt, m)")
    schemas = {}
    for call in block.split("m.def(")[1:]:
        schema = "".join(re.findall(r'"([^"]*)"', call.split(");")[0]))
        m = re.fullmatch(r"(\w+)\((.*)\) -> .+", schema)
        assert m, schema
        schemas[m.group(1)] = _top_level_args(m.group(2))
    return schemas


def wrapper_calls() -> dict:
    """{op name: [argument counts]} of every _build.op("name")(...) call
    in the ops modules."""
    calls = {}
    for path in OPS_DIR.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            f = node.func if isinstance(node, ast.Call) else None
            if (isinstance(f, ast.Call) and isinstance(f.func, ast.Attribute)
                    and f.func.attr == "op"
                    and getattr(f.func.value, "id", None) == "_build"):
                assert not node.keywords, ast.dump(node)
                calls.setdefault(f.args[0].value, []).append(len(node.args))
    return calls


OPS = ("cascade_pad", "octave_response", "octave_response_stage", "conv7",
       "window_copy", "transpose_pad", "launch_probe", "probe_primitive",
       "resconv7", "pcconv")


def test_wrappers_call_every_defined_operator():
    assert set(defined_schemas()) == set(wrapper_calls()) == set(OPS)


@pytest.mark.parametrize("name", OPS)
def test_operator_argument_count(name):
    n = len(defined_schemas()[name])
    assert wrapper_calls()[name] == [n]


def test_only_cuda_implementations():
    """Each operator has a CUDA implementation and no other: a CPU
    tensor never reaches an operator (its wrapper runs the plain
    version first)."""
    text = BINDINGS.read_text()
    impls = re.findall(r"TORCH_LIBRARY_IMPL\(akt, (\w+), m\)", text)
    assert impls == ["CUDA"]
    block = _block(text, "TORCH_LIBRARY_IMPL(akt, CUDA, m)")
    assert sorted(re.findall(r'm\.impl\("(\w+)"', block)) == sorted(OPS)
    assert "#include <torch/extension.h>" not in text


@pytest.mark.parametrize("name", ["cascade_pad", "octave_response"])
def test_in_place_outputs_are_marked(name):
    """Kernel A writes into its octave's slice of the stream arena, kernel
    B into the rows of its caller's feature tensor."""
    out = [a for a in defined_schemas()[name] if a.endswith(" out")]
    assert out == ["Tensor(a!) out"]


def test_kernel_path_has_no_ctypes():
    for path in OPS_DIR.glob("*.py"):
        text = path.read_text()
        assert "ctypes" not in text and "_SIGNATURES" not in text, path.name


# ---------------------------------------------------------------------------
# the wrappers off the card
# ---------------------------------------------------------------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _stream16():
    return _meta(2, 4096, dtype=torch.int16)


def _starts():
    return _meta(8, dtype=torch.int32)


def _bank():
    return K.Bank(_meta(72, 512), _meta(64, 32, 18), _meta(64, 32, 18))


WRAPPERS = {   # wrapper, its plain version's name in its module, arguments
    "cascade_pad": (K, "cascade_pad", "cascade_pad_plain", lambda: (
        _meta(2, 4096), 256, 3000, 1500, _meta(2, 2024),
        np.zeros(49, np.float32))),
    "octave_response": (
        K, "octave_response", "octave_response_arena_plain", lambda: (
            _stream16(), _meta(2, 6000), K.arena_layout(3000, 8, 512),
            _meta(8, 8, dtype=torch.int32), _bank(), _meta(8, 36),
            _meta(2, 288, 8))),
    "octave_response_stage": (
        K, "octave_response_stage", "octave_response_stage_plain",
        lambda: (_stream16(), _starts(), _bank(), _meta(36), "gemm")),
    "conv7": (CS, "conv7_layer", "conv7_layer_plain", lambda: (
        _meta(1, 8, 8, 8, dtype=torch.bfloat16),
        _meta(7, 4, 2, 8, 8, dtype=torch.bfloat16), _meta(8))),
    "resconv7": (RS, "resconv7", "resconv7_plain", lambda: (
        _meta(1, 5, 8, 8), RS.Conv(_meta(5, 7, 7, 8), _meta(8), _meta(8),
                                   _meta(8)))),
    "pcconv": (PS, "pcconv", "pcconv_plain", lambda: (
        _meta(1, 4, 12, 8), PS.Conv(_meta(4, 7, 12, 8), _meta(8), _meta(8),
                                    _meta(8)))),
    "window_copy": (PC, "window_copy", "window_copy_plain", lambda: (
        _stream16(), _starts(), "dma3", 8, 528)),
    "transpose_pad": (PC, "transpose_pad", "transpose_pad_plain",
                      lambda: (_stream16(), 256, 8192)),
    "launch_probe": (PC, "launch_probe", "launch_probe_plain",
                     lambda: (_stream16(), 201)),
    "probe_primitive": (PC, "primitive", "primitive_plain", lambda: (
        "p3_int16", _meta(8, 128, dtype=torch.int16))),
}


@pytest.mark.parametrize("name", OPS)
def test_wrapper_refuses_meta_tensor(name, monkeypatch):
    """A meta tensor (neither CPU nor CUDA) raises ValueError before the
    plain version, the library or the operator is reached."""
    mod, fn_name, plain_name, args = WRAPPERS[name]

    def reached(*a, **k):
        raise AssertionError("reached")
    monkeypatch.setattr(mod, plain_name, reached)
    monkeypatch.setattr(_build, "library", reached)
    monkeypatch.setattr(_build, "op", reached)
    fn = getattr(mod, fn_name)
    before = fn.launches
    with pytest.raises(ValueError):
        fn(*args())
    assert fn.launches == before


def test_importing_the_port_loads_no_library():
    """Every ops module and entry point imports without building or
    loading the kernel library or registering an akt operator."""
    code = (
        "import importlib, pkgutil, torch\n"
        "import audio_key_estimation_torch.ops as ops\n"
        "import audio_key_estimation_torch.scripts as scripts\n"
        "for pkg in (ops, scripts):\n"
        "    for m in pkgutil.iter_modules(pkg.__path__):\n"
        "        importlib.import_module(f'{pkg.__name__}.{m.name}')\n"
        "from audio_key_estimation_torch.ops import _build\n"
        "assert _build.library.cache_info().currsize == 0\n"
        "assert _build.op.cache_info().currsize == 0\n"
        "assert _build.registered_ops() == []\n"
        "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


# ---------------------------------------------------------------------------
# #8's launch count: launches that ran, not calls captured into a graph
# ---------------------------------------------------------------------------

class _OnCard:
    """Stands in for a CUDA tensor: what launch_probe and the host rows
    read of x before the operator or launcher, which the tests below
    replace."""
    is_cpu = False
    is_cuda = True
    device = torch.device("cpu")

    def data_ptr(self):
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    """launch_probe's operator, stream-capture state and CUDA graph
    replaced by stand-ins; returns the operator's real invocations."""
    state = {"capturing": False, "op_calls": 0, "replays": 0}

    def operator(x, grid_n, repeats):
        state["op_calls"] += repeats
        return torch.zeros(grid_n, 8, 128)

    class Graph:
        def replay(self):
            state["replays"] += 1

    class Capture:
        def __init__(self, graph):
            pass

        def __enter__(self):
            state["capturing"] = True

        def __exit__(self, *exc):
            state["capturing"] = False

    monkeypatch.setattr(_build, "op", lambda name: operator)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: state["capturing"])
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", Capture)
    monkeypatch.setattr(PC.launch_probe, "launches", 0)
    return state


def test_launch_probe_counts_no_captured_call(fake_card):
    """The calls captured into a graph launch nothing and add nothing;
    every replay adds the graph's launches."""
    replay, outs = PC.launch_graph(_OnCard(), 201, 100)
    assert len(outs) == 100 and fake_card["op_calls"] == 101
    assert PC.launch_probe.launches == 1      # the call before the capture
    for _ in range(3):
        replay()
    assert fake_card["replays"] == 3
    assert PC.launch_probe.launches == 1 + 3 * 100
    PC.launch_probe(_OnCard(), 1, repeats=2)
    assert PC.launch_probe.launches == 1 + 3 * 100 + 2


def test_host_rows_count_every_launch(fake_card, monkeypatch):
    """The host-cost rows of probe_pallas_overhead launch #8 through its
    wrapper, its operator and its C launcher; the count holds them all."""
    def launcher(x, out, grid_n, repeats, stream):
        fake_card["op_calls"] += repeats
        return 0
    monkeypatch.setattr(probe_pallas_overhead, "_c_launcher",
                        lambda: launcher)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    rows = probe_pallas_overhead.host_rows(_OnCard(), rounds=2, calls=3)
    assert len(rows) == 8 and all(v >= 0 for v in rows.values())
    assert fake_card["op_calls"] == 4 * (2 + 1) * 3
    assert PC.launch_probe.launches == fake_card["op_calls"]
