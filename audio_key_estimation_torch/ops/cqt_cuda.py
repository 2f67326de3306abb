"""The CQT front-end on the card: kernels A and B and the octave loop.

`cqt_cuda(y, p, stream_dtype)` computes the same (B, n_bins, T) log1p-CQT
as ops/cqt.py::cqt — the semantics of the JAX package's
`ops/cqt_pallas.py::cqt_pallas` — through two hand-written CUDA kernels
(csrc/):

  kernel A  cascade_pad       csrc/cqt_decimate.cu: one octave step, the
            half-band decimate of octave o-1's padded stream written as
            octave o's reflect-padded stream (replaces cqt_pallas.py
            `_cascade_pad_tm` + `_reflect_fix`);
  kernel B  octave_response   csrc/cqt_response.cu: frame gather x bank
            GEMM -> magnitude -> scale -> log1p, written into the octave's
            rows of the output (replaces `_octave_response_frames` and
            `_octave_response_span`); `octave_response_stage` runs
            it cut off after one stage (load / realign / gemm / full),
            the counterpart of scripts/probe_cqt_kernel_stages.py.

Streams are batch-major (B, Lpad) rows: octave 0 keeps the input dtype
(int16 PCM stays int16), octaves >= 1 are stored at `stream_dtype`. Each
wrapper launches its kernel for a CUDA tensor (or raises) and runs the
kernel's plain PyTorch version only for a CPU tensor; `launches` counts
kernel launches.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build
from .cqt import (CQTParams, _frame_starts, bank_matrix, decimation_taps,
                  downsample2, input_scale, kernel_bank, octave_response as
                  octave_response_plain, octave_scales, pad_stream,
                  stream_lengths)

_STREAM_DTYPES = (torch.float32, torch.bfloat16)


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
                length: int, taps: np.ndarray,
                out_dtype: torch.dtype) -> torch.Tensor:
    """(B, Lpad_in) padded stream of octave o-1 -> (B, length) padded
    stream of octave o (kernel A on CUDA, its plain version on CPU)."""
    if buf.is_cpu:
        return cascade_pad_plain(buf, head, L_in, L_out, length, taps,
                                 out_dtype)
    if not buf.is_cuda:
        raise ValueError(f"cascade_pad: unsupported device {buf.device}")
    if buf.dtype not in _build.KERNEL_DTYPES:
        raise ValueError(f"cascade_pad: input dtype {buf.dtype}")
    if out_dtype not in _STREAM_DTYPES:
        raise ValueError(f"cascade_pad: out {out_dtype}")
    _require(buf.ndim == 2 and buf.stride(1) == 1,
             "cascade_pad: input rows must be contiguous")
    if not (head + L_in <= buf.shape[1] and L_out == (L_in - 1) // 2 + 1
            and length >= L_out + 2 * head + 1):
        raise ValueError(f"cascade_pad: geometry head={head} L_in={L_in} "
                         f"L_out={L_out} length={length} "
                         f"buf={tuple(buf.shape)}")
    taps = np.asarray(taps, np.float32)
    if taps.shape != (49,):
        raise ValueError(f"cascade_pad: taps {taps.shape}")
    out = _build.op("cascade_pad")(buf, head, L_in, L_out, length,
                                   taps.tolist(), out_dtype)
    cascade_pad.launches += 1
    return out


cascade_pad.launches = 0


# ---------------------------------------------------------------------------
# kernel B: octave response
# ---------------------------------------------------------------------------

def octave_response(ypad: torch.Tensor, starts: torch.Tensor,
                    bank_t: torch.Tensor, scales: torch.Tensor,
                    out: torch.Tensor, row0: int) -> None:
    """Write one octave's log1p responses into out[:, row0:row0+bpo, :].

    ypad (B, Lpad) padded stream; starts (T,) int32 window starts, each
    window inside ypad's rows (`padded_length` and `_frame_starts` make
    that hold for cqt_cuda's octaves); bank_t (2*bpo, n_fft) float32
    [cos; sin]; scales (bpo,) float32; out (B, n_bins, T) float32.
    Kernel B on CUDA, plain version on CPU.
    """
    bpo = bank_t.shape[0] // 2
    if ypad.is_cpu:
        out[:, row0:row0 + bpo] = octave_response_plain(
            ypad, starts, bank_t.T, scales)
        return
    if not ypad.is_cuda:
        raise ValueError(f"octave_response: unsupported device "
                         f"{ypad.device}")
    if ypad.dtype not in _build.KERNEL_DTYPES:
        raise ValueError(f"octave_response: input dtype {ypad.dtype}")
    _require(ypad.ndim == 2 and ypad.stride(1) == 1,
             "octave_response: stream rows must be contiguous")
    B, _, T = out.shape
    if not (out.dtype == torch.float32 and out.is_contiguous()
            and ypad.shape[0] == B and row0 + bpo <= out.shape[1]):
        raise ValueError(f"octave_response: out {out.dtype} "
                         f"{tuple(out.shape)}")
    _require(starts.dtype == torch.int32 and starts.shape == (T,)
             and starts.is_cuda, "octave_response: starts must be (T,) "
             "int32 on the device")
    for t in (bank_t, scales):
        _require(t.dtype == torch.float32 and t.is_contiguous()
                 and t.is_cuda, "octave_response: bank/scales must be "
                 "contiguous float32 on the device")
    if not (bank_t.ndim == 2 and scales.shape == (bpo,)):
        raise ValueError(f"octave_response: bank {tuple(bank_t.shape)}, "
                         f"scales {tuple(scales.shape)}")
    _build.op("octave_response")(ypad, starts, bank_t, scales, out, row0)
    octave_response.launches += 1


octave_response.launches = 0


# stage codes of csrc/cqt_response.cu
STAGES = ("load", "realign", "gemm", "full")
_ALIGN = 16   # the TPU's sublane alignment of window starts


def octave_response_stage_plain(ypad: torch.Tensor, starts: torch.Tensor,
                                bank_t: torch.Tensor, scales: torch.Tensor,
                                stage: str) -> torch.Tensor:
    """Plain version of the stage probe: (B, bpo, T) float32.

    load    x[start // 16 * 16 + i], i < bpo (the raw aligned window);
    realign x[start + i];
    gemm    cos rows of bank @ the window at the aligned start (unrotated);
    full    kernel B's log1p responses.
    """
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
                          bank_t: torch.Tensor, scales: torch.Tensor,
                          stage: str) -> torch.Tensor:
    """Kernel B cut off after `stage` -> (B, bpo, T) float32 (the kernel
    on CUDA, the plain version on CPU). Same arguments and preconditions
    as `octave_response`; the aligned windows of load and gemm lie inside
    the exact ones' rows, since starts are >= 0."""
    if ypad.is_cpu:
        return octave_response_stage_plain(ypad, starts, bank_t, scales,
                                           stage)
    if stage not in STAGES:
        raise ValueError(f"stage {stage!r}: one of {STAGES}")
    if not ypad.is_cuda:
        raise ValueError(f"octave_response_stage: unsupported device "
                         f"{ypad.device}")
    if not (ypad.dtype in _build.KERNEL_DTYPES and ypad.ndim == 2
            and ypad.stride(1) == 1):
        raise ValueError(f"octave_response_stage: stream {ypad.dtype} "
                         f"{tuple(ypad.shape)} with contiguous rows")
    bpo = bank_t.shape[0] // 2
    _require(starts.dtype == torch.int32 and starts.ndim == 1
             and starts.is_cuda, "octave_response_stage: starts must be "
             "(T,) int32 on the device")
    for t in (bank_t, scales):
        _require(t.dtype == torch.float32 and t.is_contiguous()
                 and t.is_cuda, "octave_response_stage: bank/scales must "
                 "be contiguous float32 on the device")
    if not (bank_t.ndim == 2 and scales.shape == (bpo,)):
        raise ValueError(f"octave_response_stage: bank "
                         f"{tuple(bank_t.shape)}, scales "
                         f"{tuple(scales.shape)}")
    out = _build.op("octave_response_stage")(ypad, starts, bank_t, scales,
                                             STAGES.index(stage))
    octave_response_stage.launches += 1
    return out


octave_response_stage.launches = 0


# ---------------------------------------------------------------------------
# the octave loop
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _constants(p: CQTParams, n_frames: int, in_scale: float, device: str):
    """Device-resident bank, per-octave window starts and scales for one
    geometry (cached: serving repeats a few bucket geometries)."""
    dev = torch.device(device)
    bank_t = torch.as_tensor(np.ascontiguousarray(bank_matrix(p).T),
                             device=dev)
    starts = [torch.tensor(_frame_starts(p.hop, o, n_frames),
                           dtype=torch.int32, device=dev)
              for o in range(p.octaves)]
    scales = [torch.as_tensor(octave_scales(p, o, in_scale), device=dev)
              for o in range(p.octaves)]
    return bank_t, starts, scales


def cqt_cuda(y: torch.Tensor, p: CQTParams, *,
             stream_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Batched log1p-CQT through kernels A and B: (B, L) -> (B, n_bins, T).

    Same semantics as ops/cqt.py::cqt. y is int16 PCM or float; any B.
    """
    if y.ndim == 1:
        y = y[None]
    if stream_dtype not in _STREAM_DTYPES:
        raise ValueError(f"stream_dtype {stream_dtype}: float32 or bfloat16")
    in_scale = input_scale(y)
    n_fft = kernel_bank(p)["n_fft"]
    head = n_fft // 2
    bpo = p.bins_per_octave
    B, L = y.shape
    n_frames = 1 + L // p.hop
    lens = stream_lengths(L, p.octaves)
    bank_t, starts, scales = _constants(p, n_frames, in_scale,
                                        str(y.device))
    out = torch.empty(B, p.n_bins, n_frames, dtype=torch.float32,
                      device=y.device)
    cur = y if y.dtype == torch.int16 else y.float()
    buf = pad_stream(cur.contiguous(), head, padded_length(L, n_fft))
    for o in range(p.octaves):
        if o > 0:
            buf = cascade_pad(buf, head, lens[o - 1], lens[o],
                              padded_length(lens[o], n_fft),
                              decimation_taps(o, in_scale), stream_dtype)
        # octave o analyzes bins [n_bins - (o+1)*bpo : n_bins - o*bpo]
        octave_response(buf, starts[o], bank_t, scales[o], out,
                        row0=(p.octaves - 1 - o) * bpo)
    return out
