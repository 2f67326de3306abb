"""The probe and experiment kernels on the card, each beside its plain version.

Counterparts of the TPU kernels in the JAX package's `scripts/` (the
probes that told what bounds a kernel where no hardware counter could):

  window_copy   csrc/probe_window_copy.cu  <- probe_dma_rate.py::build
  transpose_pad csrc/transpose_pad.cu      <- experiment_transpose_kernel.py
                                              ::_transpose_pad_call
  launch_probe  csrc/probe_launch.cu       <- probe_pallas_overhead.py::build
  primitive     csrc/probe_primitives.cu   <- probe_pallas_primitives.py
                                              p1_reshape .. p5_window

(The stage split of kernel B, probe_cqt_kernel_stages.py, is
`cqt_cuda.octave_response_stage`.) Each wrapper launches its kernel for a
CUDA tensor (or raises) and runs the plain PyTorch version only for a CPU
tensor; `launches` counts kernel launches. `response_plan` and `tp_plan`
are copies of the JAX package's geometry rules (those modules import
JAX), pinned to the originals by tests/test_torch_probes.py.
`window_plan` and `transpose_plan` size the two copy kernels' grids
(clip chunks, runs, shared memory); tests/test_torch_copy_plans.py holds
them to their rules on the CPU.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build
from .cqt import pad_stream
from .cqt_cuda import _require

ALIGN = 16                # the TPU's sublane alignment of window starts
STATIC_STRIDE = 8816      # dma3_static's frame spacing at 44.1 kHz
WINDOW_VARIANTS = ("grid", "dma1", "dma3", "dma3_static", "dma3_big",
                   "dma3_db")
PRIMITIVES = {            # name: (input shape, input dtype, output shape)
    "p1_reshape": ((8, 128), torch.float32, (4, 256)),
    "p2_strided": ((8, 128), torch.float32, (4, 256)),
    "p3_int16": ((8, 128), torch.int16, (8, 128)),
    "p4_dma": ((4, 4096), torch.float32, (4, 256)),
    "p4b_dma_2d": ((64, 256), torch.float32, (4, 16, 256)),
    "p5_window": ((9, 256), torch.float32, (8, 304)),
}
_SMEM_BUDGET = 64 << 10   # staged window bytes per window_copy block
SMEM_PER_SM = 228 << 10   # an H100 SM's shared memory (L1 carve-out)
SMEM_PER_BLOCK = 227 << 10  # the most one block may ask for
BLOCKS_PER_SM = 2         # window_copy: resident blocks to fill an SM
DB_STEPS = 4              # steps one dma3_db block walks (kDbSteps)

# audio_key_estimation_tpu/ops/cqt_pallas.py response-kernel budgets
_TILE_T = 8
_VMEM_BUDGET = 12 << 20
_VMEM_CHUNK_BUDGET = 10 << 20
# scripts/experiment_transpose_kernel.py block sizes
_TP_SUP = 4096


def response_plan(n_fft: int, b_pad: int, itemsize: int):
    """(tile_t, b_chunk): cqt_pallas.py::_response_plan, the frames per
    grid step the TPU's response kernel and its probes use."""
    win = n_fft + ALIGN
    per_lane = 2 * win * itemsize + n_fft * 4
    if b_pad * per_lane <= _VMEM_BUDGET:
        tile_t = max(1, min(_TILE_T, _VMEM_BUDGET // (b_pad * per_lane)))
        return tile_t, b_pad
    return 1, min(_VMEM_CHUNK_BUDGET // per_lane // 128 * 128, b_pad)


def tp_plan(L: int, half: int, need: int, sup: int):
    """experiment_transpose_kernel.py::_tp_plan: (ok, C, lfull, tb_abs,
    hbi, top_off, tbi, rem) of the TPU kernel's block layout."""
    C = (L // 128) * 128
    tb_abs = half + C
    lfull = -(-max(need, tb_abs + 1) // sup) * sup
    hbi, top_off = divmod(half, sup)
    tbi, rem = divmod(tb_abs, sup)
    ok = (half >= 128 and half % 128 == 0 and C >= sup and tbi >= hbi + 1)
    return ok, C, lfull, tb_abs, hbi, top_off, tbi, rem


# ---------------------------------------------------------------------------
# #5 window copy
# ---------------------------------------------------------------------------

def static_stride(hop: int, t_pad: int, win: int, Lpad: int) -> int:
    """dma3_static's frame spacing: the hop rounded down to 16 (the TPU
    probe's 8816 at 44.1 kHz), cut in steps of 16 until the last window
    ends inside the stream (at its own default geometry the TPU probe's
    padding frames ran past the end)."""
    s = hop // ALIGN * ALIGN
    if t_pad > 1:
        s = min(s, (Lpad - win) // (t_pad - 1) // ALIGN * ALIGN)
    return s


def window_offsets(starts: torch.Tensor, variant: str, tile_t: int,
                   win: int, Lpad: int,
                   static_stride: int = STATIC_STRIDE) -> torch.Tensor:
    """(t_pad / tile_t,) int64: each step's aligned offset of window 0."""
    first = starts.long()[::tile_t]
    if variant == "dma3_static":
        step = torch.arange(first.shape[0], device=starts.device)
        first = step * tile_t * static_stride
    elif variant == "dma3_big":
        first = first.clamp(max=Lpad - tile_t * win - ALIGN)
    return first // ALIGN * ALIGN


class WindowPlan(NamedTuple):
    """window_copy's grid: (x_blocks, n_chunks) blocks of up to `chunk`
    clips, `smem` bytes of staged windows each."""
    chunk: int
    n_chunks: int
    x_blocks: int
    smem: int


@functools.lru_cache(maxsize=256)
def window_plan(variant: str, batch: int, grid_n: int, tile_t: int,
                win: int, n_sm: int) -> WindowPlan:
    """The fewest clip chunks (each within _SMEM_BUDGET) whose grid
    holds BLOCKS_PER_SM blocks on each of n_sm SMs, or one clip a chunk
    where none does. The kernel splits the clips evenly: chunk y holds
    clips [y B / n_chunks, (y + 1) B / n_chunks), at most `chunk`. `grid`
    takes dma3's chunks (the same grid, with no copies)."""
    copies = "dma3" if variant == "grid" else variant
    db = copies == "dma3_db"
    slots = 2 if db else 1
    n_win = 1 if copies in ("dma1", "dma3_big") else tile_t
    span = tile_t * win if copies == "dma3_big" else win
    per_clip = slots * n_win * span * 2
    x_blocks = -(-grid_n // DB_STEPS) if db else grid_n
    max_chunk = max(1, min(batch, _SMEM_BUDGET // per_clip))
    n = -(-batch // max_chunk)
    while True:
        chunk = -(-batch // n)
        n_chunks = -(-batch // chunk)
        if chunk == 1 or x_blocks * n_chunks >= BLOCKS_PER_SM * n_sm:
            break
        n += 1
    smem = 0 if variant == "grid" else chunk * per_clip
    return WindowPlan(chunk, n_chunks, x_blocks, smem)


def window_copy_plain(x: torch.Tensor, starts: torch.Tensor, variant: str,
                      tile_t: int, win: int,
                      static_stride: int = STATIC_STRIDE) -> torch.Tensor:
    """(t_pad / tile_t, tile_t, 1) float32: per step, 1.0 for `grid`, else
    x[0, offset of window 0 + i] for i < tile_t (the sample the TPU probe
    writes from frames[0, i, 0])."""
    if variant not in WINDOW_VARIANTS:
        raise ValueError(f"variant {variant!r}")
    grid_n = starts.shape[0] // tile_t
    if variant == "grid":
        return torch.ones(grid_n, tile_t, 1, device=x.device)
    off = window_offsets(starts, variant, tile_t, win, x.shape[1],
                         static_stride)
    idx = off.to(x.device)[:, None] + torch.arange(tile_t, device=x.device)
    return x[0, idx].float()[..., None]


def window_copy_bytes(variant: str, t_pad: int, tile_t: int, win: int,
                      B: int) -> int:
    """Stream bytes a variant stages (int16 windows)."""
    chain = t_pad * win * B * 2
    return {"grid": 0, "dma1": chain // tile_t}.get(variant, chain)


def window_copy(x: torch.Tensor, starts: torch.Tensor, variant: str,
                tile_t: int, win: int,
                static_stride: int = STATIC_STRIDE) -> torch.Tensor:
    """Stage the frame windows of an int16 (B, Lpad) stream as `variant`
    copies them (probe_window_copy.cu; its plain version on CPU). A call
    captured into a CUDA graph launches nothing and is not counted.

    starts (t_pad,) int32, t_pad a multiple of tile_t; every window
    [start // 16 * 16, + win) must lie inside the stream's rows. dma3_static
    reads the windows at (t * static_stride) // 16 * 16 instead (the TPU
    probe's 8816 is its 44.1 kHz hop rounded down to 16)."""
    if x.is_cpu:
        return window_copy_plain(x, starts, variant, tile_t, win,
                                 static_stride)
    if variant not in WINDOW_VARIANTS:
        raise ValueError(f"variant {variant!r}")
    _require(x.is_cuda and x.dtype == torch.int16 and x.ndim == 2
             and x.stride(1) == 1 and x.stride(0) % 8 == 0
             and x.data_ptr() % 16 == 0,
             "window_copy: x must be a CUDA int16 (B, Lpad) stream with "
             "16-byte aligned rows")
    _require(starts.dtype == torch.int32 and starts.ndim == 1
             and starts.is_cuda and starts.shape[0] % tile_t == 0,
             "window_copy: starts must be (t_pad,) int32 on the device, "
             "t_pad a multiple of tile_t")
    B, Lpad = x.shape
    t_pad = starts.shape[0]
    if variant == "dma3_static":
        _require(static_stride >= 0 and (t_pad - 1) * static_stride
                 // ALIGN * ALIGN + win <= Lpad,
                 "window_copy: dma3_static windows run past the stream")
    plan = window_plan(variant, B, t_pad // tile_t, tile_t, win,
                       sm_count(x.device))
    out = _build.op("window_copy")(x, starts, tile_t, win, plan.chunk,
                                   WINDOW_VARIANTS.index(variant),
                                   static_stride)
    if not torch.cuda.is_current_stream_capturing():
        window_copy.launches += 1
    return out


window_copy.launches = 0


# ---------------------------------------------------------------------------
# #7 transpose-pad
# ---------------------------------------------------------------------------

def transpose_pad_geometry(y: torch.Tensor, last_start: int, n_fft: int):
    """lfull of transpose_pad_tm at this geometry, or None where the TPU
    kernel's _tp_plan refuses it."""
    B, L = y.shape
    half = n_fft // 2
    need = last_start + n_fft + ALIGN
    sup = _TP_SUP if y.dtype.itemsize == 2 else _TP_SUP // 2
    ok, _, lfull, *_ = tp_plan(L, half, need, sup)
    if not ok or L < half + 2:
        return None
    return lfull


TP_THREADS = 256          # transpose_pad.cu kThreads
TP_MAX_CHUNK = 32         # clips one work item stages (kMaxChunk)
TP_SLOT_PAD = 128         # a clip slot's bytes beyond its run (kSlotPad)
TP_STAGE_BYTES = 32 << 10  # staged run bytes per stage, all clips
TP_MAX_BLOCKS_PER_SM = 4


class TransposePlan(NamedTuple):
    """transpose_pad's work: n_runs runs of run_rows output rows times
    n_chunks chunks of up to `chunk` clips, walked by a persistent grid
    of `grid` blocks with two stages of `chunk` slots of `row_bytes`."""
    chunk: int
    n_chunks: int
    run_rows: int
    n_runs: int
    row_bytes: int
    smem: int
    grid: int


@functools.lru_cache(maxsize=256)
def transpose_plan(B: int, lfull: int, itemsize: int,
                   n_sm: int) -> TransposePlan:
    """Chunks of min(B, 32) clips; runs of TP_STAGE_BYTES / chunk bytes
    a clip (chunk rounded up to a power of two; 2 to 16 KB, a multiple of
    128); as many blocks per SM as two stages leave room for (1 KB a
    block reserved), at most TP_MAX_BLOCKS_PER_SM, and no more blocks
    than work items. This plan is the one place that fixes the kernel's
    run_rows, chunk and grid. Chosen by a sweep on the H100 (int16,
    120 s; `scripts/time_copy_kernels.py --sweep` at commit 3e027df, not
    kept): 2 KB a clip was fastest at B = 16 (3 blocks an SM) and at
    B = 256 (chunks of 32, 1 block an SM), 1 KB and 0.5 KB slower at
    every block count."""
    chunk = min(B, TP_MAX_CHUNK)
    n_chunks = -(-B // chunk)
    cp = 1 << (chunk - 1).bit_length()
    run_bytes = max(2 << 10, min(16 << 10, TP_STAGE_BYTES // cp))
    run_rows = run_bytes // itemsize
    n_runs = -(-lfull // run_rows)
    row_bytes = run_bytes + TP_SLOT_PAD
    smem = 2 * chunk * row_bytes
    per_sm = max(1, min(TP_MAX_BLOCKS_PER_SM,
                        SMEM_PER_SM // (smem + (1 << 10))))
    grid = min(n_runs * n_chunks, n_sm * per_sm)
    return TransposePlan(chunk, n_chunks, run_rows, n_runs, row_bytes, smem,
                         grid)


def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def transpose_pad_plain(y: torch.Tensor, half: int,
                        lfull: int) -> torch.Tensor:
    """(B, L) -> (lfull, B): y reflect-padded by (half, half + 1), zeros
    beyond, cut to lfull rows, time-major."""
    return pad_stream(y, half, lfull)[:, :lfull].T.contiguous()


def transpose_pad_tm(y: torch.Tensor, last_start: int,
                     n_fft: int) -> torch.Tensor | None:
    """experiment_transpose_kernel.py::transpose_pad_tm: the fused
    (B, L) -> (lfull, B) transpose + reflect pad + zero extension, int16
    or float32; None where that function returns None."""
    lfull = transpose_pad_geometry(y, last_start, n_fft)
    if lfull is None:
        return None
    return transpose_pad(y, n_fft // 2, lfull)


def transpose_pad(y: torch.Tensor, half: int, lfull: int) -> torch.Tensor:
    """transpose_pad.cu on CUDA, its plain version on CPU. A call
    captured into a CUDA graph launches nothing and is not counted."""
    if y.is_cpu:
        return transpose_pad_plain(y, half, lfull)
    _require(y.is_cuda and y.dtype in (torch.int16, torch.float32)
             and y.ndim == 2 and y.stride(1) == 1,
             "transpose_pad: y must be a CUDA int16/float32 (B, L) tensor "
             "with contiguous rows")
    _require(y.shape[1] >= half + 2, "transpose_pad: L < half + 2")
    plan = transpose_plan(y.shape[0], lfull, y.element_size(),
                          sm_count(y.device))
    out = _build.op("transpose_pad")(y, half, lfull, plan.run_rows,
                                     plan.chunk, plan.grid)
    if not torch.cuda.is_current_stream_capturing():
        transpose_pad.launches += 1
    return out


transpose_pad.launches = 0


# ---------------------------------------------------------------------------
# #8 launch overhead
# ---------------------------------------------------------------------------

def launch_probe_plain(x: torch.Tensor, grid_n: int) -> torch.Tensor:
    """(grid_n, 8, 128) float32 ones; x is never read."""
    return torch.ones(grid_n, 8, 128, device=x.device)


def launch_probe(x: torch.Tensor, grid_n: int,
                 repeats: int = 1) -> torch.Tensor:
    """probe_launch.cu: grid_n blocks write ones and never read x; the
    kernel is launched `repeats` times back to back from one operator
    call. Like torch.ones, a shape check and then the operator, which
    allocates the output and launches on the current stream.

    A call made while the stream is captured into a CUDA graph launches
    nothing and is not counted: `launch_graph` counts the launches of
    each replay."""
    if x.is_cpu:
        return launch_probe_plain(x, grid_n)
    if not (x.is_cuda and grid_n >= 1 and repeats >= 1):
        raise ValueError(f"launch_probe: CUDA input, grid_n >= 1, "
                         f"repeats >= 1 ({x.device}, {grid_n}, {repeats})")
    out = _build.op("launch_probe")(x, grid_n, repeats)
    if not torch.cuda.is_current_stream_capturing():
        launch_probe.launches += repeats
    return out


launch_probe.launches = 0


def launch_graph(x: torch.Tensor, grid_n: int, n: int):
    """n launch_probe calls captured into one torch.cuda.CUDAGraph ->
    (replay, outs): replay() replays the graph, n launches, and counts
    them; outs are the n outputs, which live in the graph's memory pool
    and are written only by a replay."""
    launch_probe(x, grid_n)          # load the library before the capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [launch_probe(x, grid_n) for _ in range(n)]

    def replay():
        graph.replay()
        launch_probe.launches += n
    return replay, outs


# ---------------------------------------------------------------------------
# #9 primitives
# ---------------------------------------------------------------------------

def primitive_input(name: str) -> torch.Tensor:
    """The input each probe of probe_pallas_primitives.py builds."""
    shape, dtype, _ = PRIMITIVES[name]
    n = shape[0] * shape[1]
    if dtype == torch.int16:
        return (torch.arange(n) % 3001 - 1500).to(torch.int16).reshape(shape)
    return torch.arange(n, dtype=torch.float32).reshape(shape)


def primitive_plain(name: str, x: torch.Tensor) -> torch.Tensor:
    """The array each probe of probe_pallas_primitives.py expects."""
    if name == "p1_reshape":
        return x.reshape(4, 256)
    if name == "p2_strided":
        return torch.cat([x[0::2], x[1::2]], dim=1)
    if name == "p3_int16":
        return x.float() * (1.0 / 32768.0)
    if name == "p4_dma":
        return torch.stack([x[i, i * 128 + 64:i * 128 + 320] * 2
                            for i in range(4)])
    if name == "p4b_dma_2d":
        return torch.stack([x[i * 8 + 3:i * 8 + 19] + 1 for i in range(4)])
    if name == "p5_window":
        return torch.cat([x[:8], x[1:9, :48]], dim=1)
    raise ValueError(f"primitive {name!r}: one of {tuple(PRIMITIVES)}")


def primitive(name: str, x: torch.Tensor) -> torch.Tensor:
    """probe_primitives.cu kernel `name` on CUDA, its plain version on
    CPU."""
    if x.is_cpu:
        return primitive_plain(name, x)
    if name not in PRIMITIVES:
        raise ValueError(f"primitive {name!r}")
    shape, dtype, out_shape = PRIMITIVES[name]
    if not (x.is_cuda and x.dtype == dtype and tuple(x.shape) == shape
            and x.is_contiguous()):
        raise ValueError(f"primitive {name}: needs a contiguous CUDA "
                         f"{dtype} {shape}")
    out = _build.op("probe_primitive")(x, list(PRIMITIVES).index(name),
                                       out_shape)
    primitive.launches += 1
    return out


primitive.launches = 0
