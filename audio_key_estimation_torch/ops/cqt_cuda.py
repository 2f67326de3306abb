"""The CQT front-end on the card: kernels A and B and their orchestration.

`cqt_cuda(y, p, stream_dtype)` computes the same (B, n_bins, T) log1p-CQT
as ops/cqt.py::cqt — the semantics of the JAX package's
`ops/cqt_pallas.py::cqt_pallas` — through two hand-written CUDA kernels
(csrc/):

  kernel A  cascade_pad       csrc/cqt_decimate.cu: one octave step, the
            half-band decimate of octave o-1's padded stream written as
            octave o's reflect-padded stream, straight into its slice of
            the stream arena (replaces cqt_pallas.py `_cascade_pad_tm` +
            `_reflect_fix`);
  kernel B  octave_response   csrc/cqt_response.cu: every octave in one
            launch, frame gather x bank GEMM (3xTF32 on the tensor cores)
            -> magnitude -> scale -> log1p, written into the octaves' rows
            of the output (replaces `_octave_response_frames` and
            `_octave_response_span`); `octave_response_stage` runs it on
            one octave cut off after one stage (load / realign / gemm /
            full), the counterpart of scripts/probe_cqt_kernel_stages.py.

Streams are batch-major (B, Lpad) rows. Octave 0 keeps the input dtype
(int16 PCM stays int16) in its own buffer; octaves >= 1 are stored at
`stream_dtype` in one arena, (B, sum of their padded lengths), at the
offsets `arena_layout` gives. Each wrapper launches its kernel for a CUDA
tensor (or raises) and runs the kernel's plain PyTorch version only for a
CPU tensor; `launches` counts kernel launches.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .cqt import (CQTParams, _frame_starts, bank_matrix, decimation_taps,
                  downsample2, input_scale, kernel_bank, octave_response as
                  octave_response_plain, octave_scales, pad_stream,
                  stream_lengths)

_STREAM_DTYPES = (torch.float32, torch.bfloat16)
_BANK_ROWS = 72   # csrc/cqt_response.cu kMaxRows: 2 * bpo, bpo <= 36
_CHUNK = 32       # csrc/cqt_response.cu kChunk: n_fft is a multiple of it


def padded_length(L: int, n_fft: int) -> int:
    """Rows of an octave's padded buffer: the reflect-padded stream
    (L + n_fft + 1, which covers every frame window) rounded up to 8."""
    return -(-(L + n_fft + 1) // 8) * 8


def _require(cond: bool, msg: str) -> None:
    """Raise ValueError(msg) unless cond. For a constant message; a check
    whose message formats values is an `if ...: raise`, so the message is
    built only on failure."""
    if not cond:
        raise ValueError(msg)


def _aligned_rows(t: torch.Tensor) -> bool:
    """Rows that start 16-byte aligned and stay so (the kernels' 16-byte
    loads and stores): contiguous rows, a stride of a multiple of 8."""
    return (t.ndim == 2 and t.stride(1) == 1 and t.stride(0) % 8 == 0
            and t.data_ptr() % 16 == 0)


# ---------------------------------------------------------------------------
# the stream arena
# ---------------------------------------------------------------------------

class ArenaLayout(NamedTuple):
    """Where each octave's padded stream lives. Octave 0 is its own
    buffer (offsets[0] = 0, in the input dtype); octave o >= 1 is
    arena[:, offsets[o]:offsets[o] + lengths[o]]."""
    lens: tuple       # samples of each octave's stream
    lengths: tuple    # rows of each octave's padded buffer
    offsets: tuple    # first arena column of each octave (0 for octave 0)
    width: int        # arena columns


@functools.lru_cache(maxsize=16)
def arena_layout(L: int, octaves: int, n_fft: int) -> ArenaLayout:
    lens = tuple(stream_lengths(L, octaves))
    lengths = tuple(padded_length(n, n_fft) for n in lens)
    offsets = (0, *np.cumsum((0, *lengths[1:-1])).tolist())[:octaves]
    return ArenaLayout(lens, lengths, tuple(int(o) for o in offsets),
                       int(sum(lengths[1:])))


def octave_streams(x0: torch.Tensor, arena: torch.Tensor,
                   layout: ArenaLayout) -> list[torch.Tensor]:
    """Each octave's (B, length) padded stream: x0, then arena views."""
    return [x0] + [arena[:, off:off + n] for off, n in
                   zip(layout.offsets[1:], layout.lengths[1:])]


# ---------------------------------------------------------------------------
# kernel A: half-band decimate + reflect pad
# ---------------------------------------------------------------------------

def cascade_pad_plain(buf, head, L_in, L_out, length, taps, out_dtype):
    """Plain version of kernel A: decimate the interior of `buf`
    ([head, head + L_in)), store at out_dtype, reflect-pad by
    (head, head + 1) and zero-extend to `length` rows."""
    y = downsample2(buf[:, head:head + L_in], taps, out_dtype=out_dtype)
    if y.shape[1] != L_out:
        raise ValueError(f"L_out={L_out} != {y.shape[1]}")
    return pad_stream(y, head, length)


def cascade_pad(buf: torch.Tensor, head: int, L_in: int, L_out: int,
                out: torch.Tensor, taps: np.ndarray) -> None:
    """(B, Lpad_in) padded stream of octave o-1 -> out, (B, length) padded
    stream of octave o at out's dtype, written in place (out may be a
    slice of the arena). Kernel A on CUDA (head a multiple of 8, as
    n_fft / 2 is), its plain version on CPU."""
    if buf.is_cpu:
        out.copy_(cascade_pad_plain(buf, head, L_in, L_out, out.shape[1],
                                    taps, out.dtype))
        return
    if not buf.is_cuda:
        raise ValueError(f"cascade_pad: unsupported device {buf.device}")
    if buf.dtype not in _build.KERNEL_DTYPES:
        raise ValueError(f"cascade_pad: input dtype {buf.dtype}")
    if out.dtype not in _STREAM_DTYPES:
        raise ValueError(f"cascade_pad: out {out.dtype}")
    _require(_aligned_rows(buf) and _aligned_rows(out) and out.is_cuda,
             "cascade_pad: input and output rows must be contiguous and "
             "16-byte aligned, on the device")
    length = out.shape[1]
    if not (head >= 0 and head % 8 == 0 and head + L_in <= buf.shape[1]
            and L_out == (L_in - 1) // 2 + 1
            and length >= L_out + 2 * head + 1 and length % 8 == 0
            and out.shape[0] == buf.shape[0]):
        raise ValueError(f"cascade_pad: geometry head={head} L_in={L_in} "
                         f"L_out={L_out} out={tuple(out.shape)} "
                         f"buf={tuple(buf.shape)}")
    taps = np.asarray(taps, np.float32)
    if taps.shape != (49,):
        raise ValueError(f"cascade_pad: taps {taps.shape}")
    _build.op("cascade_pad")(buf, head, L_in, L_out, out, taps.tolist())
    cascade_pad.launches += 1


cascade_pad.launches = 0


def cascade_arena(x0: torch.Tensor, layout: ArenaLayout, head: int,
                  in_scale: float, stream_dtype: torch.dtype) -> torch.Tensor:
    """Kernel A's octave steps, 1 .. octaves-1, each from the previous
    octave's stream into its slice of one new (B, width) arena."""
    arena = torch.empty(x0.shape[0], layout.width, dtype=stream_dtype,
                        device=x0.device)
    streams = octave_streams(x0, arena, layout)
    for o in range(1, len(streams)):
        cascade_pad(streams[o - 1], head, layout.lens[o - 1], layout.lens[o],
                    streams[o], decimation_taps(o, in_scale))
    return arena


# ---------------------------------------------------------------------------
# kernel B: octave response
# ---------------------------------------------------------------------------

class Bank(NamedTuple):
    """The [cos; sin] analysis bank: `t` (2*bpo, n_fft) float32 for the
    plain versions; `hi` and `lo` (n_fft / 8, 32, 18) float32, its TF32
    parts (bank = hi + lo) in the order of kernel B's mma fragments."""
    t: torch.Tensor
    hi: torch.Tensor
    lo: torch.Tensor


def tf32_round(a: np.ndarray) -> np.ndarray:
    """float32 -> the nearest TF32 value (ties away from zero), as
    `cvt.rna.tf32.f32` rounds: 10 mantissa bits kept."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def bank_fragments(bank_t: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(2*bpo, n_fft) bank -> (hi, lo), each (n_fft / 8, 32, 18): the B
    operand of mma.m16n8k8 for k8 step s, lane l and n8 tile j holds
    B[k][n] = bank_t[n][k] at k = 8s + l % 4 (+ 4 for the second
    register), n = 8j + l // 4, rows past 2*bpo zero."""
    rows, n_fft = bank_t.shape
    if rows > _BANK_ROWS or n_fft % _CHUNK:
        raise ValueError(f"bank {bank_t.shape}: at most {_BANK_ROWS} rows, "
                         f"n_fft a multiple of {_CHUNK}")
    b = np.zeros((n_fft, _BANK_ROWS), np.float32)
    b[:, :rows] = bank_t.T
    hi = tf32_round(b)
    lo = tf32_round(b - hi)
    s, lane, j, r = np.meshgrid(np.arange(n_fft // 8), np.arange(32),
                                np.arange(_BANK_ROWS // 8), np.arange(2),
                                indexing="ij")
    k = 8 * s + lane % 4 + 4 * r
    n = 8 * j + lane // 4
    shape = (n_fft // 8, 32, 2 * _BANK_ROWS // 8)
    return (np.ascontiguousarray(hi[k, n].reshape(shape)),
            np.ascontiguousarray(lo[k, n].reshape(shape)))


def make_bank(bank_t: np.ndarray, device) -> Bank:
    bank_t = np.ascontiguousarray(bank_t, np.float32)
    hi, lo = bank_fragments(bank_t)
    return Bank(*(torch.as_tensor(a, device=device) for a in (bank_t, hi,
                                                               lo)))


def octave_response_arena_plain(x0: torch.Tensor, arena: torch.Tensor,
                                layout: ArenaLayout, starts: torch.Tensor,
                                bank: Bank, scales: torch.Tensor,
                                out: torch.Tensor) -> None:
    """Plain version of kernel B: octave o's responses (octave_response_plain
    on its stream) into out[:, (octaves-1-o)*bpo : ... + bpo]."""
    n_oct, bpo = scales.shape
    for o, buf in enumerate(octave_streams(x0, arena, layout)):
        row0 = (n_oct - 1 - o) * bpo
        out[:, row0:row0 + bpo] = octave_response_plain(
            buf, starts[o], bank.t.T, scales[o])


def octave_response(x0: torch.Tensor, arena: torch.Tensor,
                    layout: ArenaLayout, starts: torch.Tensor, bank: Bank,
                    scales: torch.Tensor, out: torch.Tensor) -> None:
    """Every octave's log1p responses into out (B, octaves * bpo, T)
    float32, octave o in rows [(octaves-1-o)*bpo, +bpo): one launch of
    kernel B on CUDA, its plain version on CPU.

    x0 (B, lengths[0]) octave 0's padded stream (int16 or float32); arena
    (B, width) octaves >= 1 (float32 or bfloat16) at `layout`; starts
    (octaves, T) int32 window starts, each window inside its stream
    (`padded_length` and `_frame_starts` make that hold); scales
    (octaves, bpo) float32.
    """
    if x0.is_cpu:
        octave_response_arena_plain(x0, arena, layout, starts, bank, scales,
                                    out)
        return
    if not x0.is_cuda:
        raise ValueError(f"octave_response: unsupported device {x0.device}")
    if x0.dtype not in (torch.int16, torch.float32) \
            or arena.dtype not in _STREAM_DTYPES:
        raise ValueError(f"octave_response: streams {x0.dtype} / "
                         f"{arena.dtype}")
    n_oct, bpo = scales.shape
    _require(_aligned_rows(x0) and (n_oct == 1 or _aligned_rows(arena)),
             "octave_response: stream rows must be contiguous and 16-byte "
             "aligned")
    B, n_bins, T = out.shape
    if not (out.dtype == torch.float32 and out.is_contiguous()
            and x0.shape[0] == B and n_bins == n_oct * bpo
            and x0.shape[1] >= layout.lengths[0]
            and (n_oct == 1 or (arena.shape[0] == B
                                and arena.shape[1] >= layout.width))
            and len(layout.lengths) == n_oct):
        raise ValueError(f"octave_response: out {out.dtype} "
                         f"{tuple(out.shape)}, x0 {tuple(x0.shape)}, arena "
                         f"{tuple(arena.shape)}, {n_oct} octaves")
    _require(starts.dtype == torch.int32 and starts.shape == (n_oct, T)
             and starts.is_contiguous() and starts.is_cuda,
             "octave_response: starts must be (octaves, T) int32 on the "
             "device")
    for t in (bank.hi, bank.lo, scales):
        _require(t.dtype == torch.float32 and t.is_contiguous()
                 and t.is_cuda, "octave_response: bank/scales must be "
                 "contiguous float32 on the device")
    _build.op("octave_response")(x0, arena, list(layout.offsets),
                                 list(layout.lengths), starts, bank.hi,
                                 bank.lo, scales, out)
    octave_response.launches += 1


octave_response.launches = 0


# stage codes of csrc/cqt_response.cu
STAGES = ("load", "realign", "gemm", "full")
_ALIGN = 16   # the TPU's sublane alignment of window starts


def octave_response_stage_plain(ypad: torch.Tensor, starts: torch.Tensor,
                                bank: Bank, scales: torch.Tensor,
                                stage: str) -> torch.Tensor:
    """Plain version of the stage probe: (B, bpo, T) float32.

    load    x[start // 16 * 16 + i], i < bpo (the raw aligned window);
    realign x[start + i];
    gemm    cos rows of bank @ the window at the aligned start (unrotated);
    full    kernel B's log1p responses.
    """
    bank_t = bank.t
    bpo = bank_t.shape[0] // 2
    n_fft = bank_t.shape[1]
    if stage == "full":
        return octave_response_plain(ypad, starts, bank_t.T, scales)
    if stage not in STAGES:
        raise ValueError(f"stage {stage!r}: one of {STAGES}")
    st = starts.to(ypad.device).long()
    if stage != "realign":
        st = st // _ALIGN * _ALIGN
    width = n_fft if stage == "gemm" else bpo
    frames = ypad[:, st[:, None] + torch.arange(width, device=ypad.device)]
    frames = frames.float()                             # (B, T, width)
    if stage == "gemm":
        frames = frames @ bank_t[:bpo].T
    return frames.transpose(1, 2).contiguous()


def octave_response_stage(ypad: torch.Tensor, starts: torch.Tensor,
                          bank: Bank, scales: torch.Tensor,
                          stage: str) -> torch.Tensor:
    """Kernel B on one octave cut off after `stage` -> (B, bpo, T) float32
    (the kernel on CUDA, the plain version on CPU). ypad (B, Lpad) one
    octave's padded stream (int16, float32 or bfloat16), starts (T,)
    int32, scales (bpo,); each window inside ypad's rows, and the aligned
    windows of load and gemm lie inside the exact ones' rows, since starts
    are >= 0. The full stage is the production kernel's octave body."""
    if ypad.is_cpu:
        return octave_response_stage_plain(ypad, starts, bank, scales,
                                           stage)
    if stage not in STAGES:
        raise ValueError(f"stage {stage!r}: one of {STAGES}")
    if not ypad.is_cuda:
        raise ValueError(f"octave_response_stage: unsupported device "
                         f"{ypad.device}")
    if not (ypad.dtype in _build.KERNEL_DTYPES and _aligned_rows(ypad)):
        raise ValueError(f"octave_response_stage: stream {ypad.dtype} "
                         f"{tuple(ypad.shape)} with contiguous, 16-byte "
                         f"aligned rows")
    _require(starts.dtype == torch.int32 and starts.ndim == 1
             and starts.is_cuda, "octave_response_stage: starts must be "
             "(T,) int32 on the device")
    for t in (bank.hi, bank.lo, scales):
        _require(t.dtype == torch.float32 and t.is_contiguous()
                 and t.is_cuda, "octave_response_stage: bank/scales must "
                 "be contiguous float32 on the device")
    if scales.ndim != 1:
        raise ValueError(f"octave_response_stage: scales "
                         f"{tuple(scales.shape)}")
    out = _build.op("octave_response_stage")(ypad, starts, bank.hi, bank.lo,
                                             scales, STAGES.index(stage))
    octave_response_stage.launches += 1
    return out


octave_response_stage.launches = 0


# ---------------------------------------------------------------------------
# the front-end
# ---------------------------------------------------------------------------

class Constants(NamedTuple):
    bank: Bank
    starts: torch.Tensor   # (octaves, T) int32
    scales: torch.Tensor   # (octaves, bpo) float32


@functools.lru_cache(maxsize=64)
def _constants(p: CQTParams, n_frames: int, in_scale: float,
               device: str) -> Constants:
    """Device-resident bank (with its TF32 split), window starts and
    scales of one geometry on one device (cached: serving repeats a few
    bucket geometries; a mesh of 8 cards serving the multi-scale
    ensemble's two CQTs at three buckets holds 48)."""
    dev = torch.device(device)
    bank = make_bank(bank_matrix(p).T, dev)
    starts = torch.tensor([_frame_starts(p.hop, o, n_frames)
                           for o in range(p.octaves)], dtype=torch.int32,
                          device=dev)
    scales = torch.as_tensor(np.stack([octave_scales(p, o, in_scale)
                                       for o in range(p.octaves)]),
                             device=dev)
    return Constants(bank, starts, scales)


def cqt_cuda(y: torch.Tensor, p: CQTParams, *,
             stream_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Batched log1p-CQT through kernels A and B: (B, L) -> (B, n_bins, T).

    Same semantics as ops/cqt.py::cqt. y is int16 PCM or float; any B.
    Kernel A runs once per octave step into the arena, then kernel B once
    for every octave.
    """
    if y.ndim == 1:
        y = y[None]
    if stream_dtype not in _STREAM_DTYPES:
        raise ValueError(f"stream_dtype {stream_dtype}: float32 or bfloat16")
    in_scale = input_scale(y)
    n_fft = kernel_bank(p)["n_fft"]
    head = n_fft // 2
    B, L = y.shape
    n_frames = 1 + L // p.hop
    layout = arena_layout(L, p.octaves, n_fft)
    c = _constants(p, n_frames, in_scale, str(y.device))
    cur = y if y.dtype == torch.int16 else y.float()
    x0 = pad_stream(cur.contiguous(), head, layout.lengths[0])
    arena = cascade_arena(x0, layout, head, in_scale, stream_dtype)
    out = torch.empty(B, p.n_bins, n_frames, dtype=torch.float32,
                      device=y.device)
    octave_response(x0, arena, layout, c.starts, c.bank, c.scales, out)
    return out
