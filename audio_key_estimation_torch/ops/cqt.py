"""Constant-Q transform front-end: host constants and the plain PyTorch CQT.

The numpy constant functions (`CQTParams`, `kernel_bank`, `halfband_taps`,
`_poly_matrix`, `reference_hop`, `_frame_starts`) are copies of the JAX
package's `ops/cqt.py` and `ops/cqt_pallas.py` — those modules import JAX
— and tests/test_torch_imports.py pins each copy to its original bit for
bit.

`cqt` is the straightforward PyTorch transform with the semantics of the
JAX package's fused front-end (`ops/cqt_pallas.py::cqt_pallas`):

  * octave 0 analyzes the input signal itself; octave o > 0 analyzes the
    49-tap Kaiser half-band decimation of octave o-1
    (out[k] = sum_j taps[j] * y[2k + j - 24], zero outside the stream),
    stored at `stream_dtype` (bfloat16 halves its bytes) and accumulated
    in float32;
  * frame t of octave o is the n_fft window starting at
    floor(t * hop / 2**o + 0.5) of the stream reflect-padded by n_fft//2
    (librosa's centered frames);
  * each window times the top octave's [cos|sin] bank -> magnitude ->
    sqrt(kernel length) * 2**(o/2) scale -> log1p;
  * raw int16 PCM input stays int16: 1/32768 folds into octave 0's scales
    and the first decimation's taps.

Output (B, n_bins, T), T = 1 + L // hop, bins ascending in frequency.
The CUDA kernels that replace the TPU kernels live in ops/cqt_cuda.py.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

C1_HZ = 32.70319566257483  # librosa note_to_hz('C1')


@dataclass(frozen=True)
class CQTParams:
    sr: int
    hop: int
    bins_per_octave: int = 36
    octaves: int = 8
    fmin: float = C1_HZ
    filter_scale: float = 1.0

    @property
    def n_bins(self) -> int:
        return self.bins_per_octave * self.octaves

    @property
    def q(self) -> float:
        return self.filter_scale / (2.0 ** (1.0 / self.bins_per_octave) - 1.0)


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


@functools.lru_cache(maxsize=16)
def kernel_bank(p: CQTParams):
    """Top-octave CQT kernel bank (host-side, cached per config).

    Returns dict of numpy arrays:
      k_cos, k_sin : (n_fft, bins_per_octave) — conjugated, L1-normalized,
                     hann-windowed exponentials, centered in the n_fft window
      scales       : (bins_per_octave,) = sqrt(kernel_length)  (scale=True)
      n_fft        : frame length
    """
    bpo, q, sr = p.bins_per_octave, p.q, p.sr
    top0 = p.n_bins - bpo
    freqs = p.fmin * 2.0 ** ((top0 + np.arange(bpo)) / bpo)
    lengths = q * sr / freqs
    n_fft = _next_pow2(int(math.ceil(lengths.max())))
    k = np.zeros((n_fft, bpo), np.complex128)
    for i, (f, flen) in enumerate(zip(freqs, lengths)):
        ilen = int(np.floor(flen))
        # periodic hann window, L1-normalized (librosa filters.constant_q norm=1)
        w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(ilen) / ilen)
        w /= w.sum()
        t = np.arange(ilen) - ilen // 2
        sig = w * np.exp(-2j * np.pi * f * t / sr)
        off = (n_fft - ilen) // 2
        k[off:off + ilen, i] = sig
    return {
        "k_cos": np.ascontiguousarray(k.real, np.float32),
        "k_sin": np.ascontiguousarray(k.imag, np.float32),
        "scales": np.sqrt(lengths).astype(np.float32),
        "n_fft": n_fft,
    }


@functools.lru_cache(maxsize=4)
def halfband_taps(num_taps: int = 49) -> np.ndarray:
    """Kaiser windowed-sinc half-band lowpass for decimation by 2."""
    n = np.arange(num_taps) - (num_taps - 1) / 2
    h = np.sinc(n / 2) / 2
    beta = 8.0
    w = np.i0(beta * np.sqrt(np.clip(1 - (2 * n / (num_taps - 1)) ** 2, 0, 1)))
    w /= np.i0(beta)
    h = h * w
    return (h / h.sum() * 1.0).astype(np.float32)  # unity DC gain


_POLY_BLOCK = 256  # input samples per polyphase block (128 outputs)


@functools.lru_cache(maxsize=8)
def _poly_matrix_cached(taps_bytes: bytes, num_taps: int,
                        block: int) -> np.ndarray:
    taps = np.frombuffer(taps_bytes, np.float32)
    pad = num_taps // 2
    out_block = block // 2
    w = np.zeros((block + 2 * pad, out_block), np.float32)
    for m in range(out_block):
        w[2 * m: 2 * m + num_taps, m] = taps
    return w


def _poly_matrix(taps=None, block: int = _POLY_BLOCK) -> np.ndarray:
    """Polyphase decimation-by-2 as one dense matmul operand.

    W[(j, m)] = taps[j - 2m]: an input window of `block + 2*(taps//2)`
    samples times W yields `block//2` consecutive decimated outputs. The
    TPU's MXU form of the filter; the port's decimation is the direct FIR
    it encodes (kept so tests can pin the two formulations together).
    """
    taps = halfband_taps() if taps is None else np.asarray(taps, np.float32)
    return _poly_matrix_cached(taps.tobytes(), len(taps), block)


def reference_hop(sr: int, frames: int, window_size: int = 592,
                  signal_len: int | None = None) -> int:
    """The reference's hop rule (KeyDataset.py:485,490): frames per second,
    or window_size total frames when frames == 0."""
    if frames > 0:
        return int(round(sr / frames))
    assert signal_len is not None
    return signal_len // window_size + 1


def _frame_starts(hop: int, octave: int, n_frames: int) -> list[int]:
    """Window starts into the REFLECT-PADDED octave signal. Frame t's
    center at octave o is round(t*hop/2**o) (half-up); the n_fft//2 left
    pad makes the center the window start."""
    return [math.floor(t * hop / 2 ** octave + 0.5) for t in range(n_frames)]


def stream_lengths(L: int, octaves: int) -> list[int]:
    """Samples per octave stream: each decimation keeps ceil(L/2)."""
    lens = [L]
    for _ in range(1, octaves):
        lens.append((lens[-1] - 1) // 2 + 1)
    return lens


def input_scale(y: torch.Tensor) -> float:
    """1/32768 for raw int16 PCM, 1 for float input; other ints raise."""
    if y.dtype == torch.int16:
        return 1.0 / 32768.0
    if not y.dtype.is_floating_point:
        raise ValueError(f"raw PCM input must be int16, got {y.dtype}")
    return 1.0


def octave_scales(p: CQTParams, octave: int, in_scale: float) -> np.ndarray:
    """Per-bin epilogue scale of one octave: sqrt(kernel length) at the
    full rate (each octave down gains sqrt 2), times the PCM
    normalization at octave 0."""
    oct_scale = in_scale if octave == 0 else 1.0
    return kernel_bank(p)["scales"] * (oct_scale * 2.0 ** (octave / 2))


def decimation_taps(octave: int, in_scale: float) -> np.ndarray:
    """Half-band taps producing octave `octave` from octave-1, with the
    PCM normalization folded in at the first step (float32 product, as
    the JAX package folds it into its polyphase matrix)."""
    return halfband_taps() * np.float32(in_scale if octave == 1 else 1.0)


def downsample2(y: torch.Tensor, taps: np.ndarray, *,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Halve the sample rate: (B, L) -> (B, (L-1)//2 + 1).

    out[k] = sum_j taps[j] * y[2k + j - n_taps//2], y zero outside [0, L),
    accumulated in float32 and stored at out_dtype.
    """
    w = torch.as_tensor(np.asarray(taps, np.float32), device=y.device)
    pad = w.shape[0] // 2
    out = F.conv1d(y.float()[:, None], w[None, None], stride=2, padding=pad)
    return out[:, 0].to(out_dtype)


def reflect_index(L: int, head: int) -> np.ndarray:
    """Source sample of every row of a stream reflect-padded by
    (head, head + 1): numpy's (and jnp.pad's) 'reflect', repeated
    reflection included for streams shorter than the pad."""
    return np.pad(np.arange(L), (head, head + 1), mode="reflect")


def pad_stream(y: torch.Tensor, head: int, length: int) -> torch.Tensor:
    """(B, L) stream -> (B, max(length, L + 2*head + 1)) reflect-padded by
    (head, head + 1) and zero-extended; keeps the dtype (int16 stays
    int16)."""
    L = y.shape[1]
    if L >= head + 2:   # one reflection each side: slices, no index table
        ypad = torch.cat([y[:, 1:head + 1].flip(1), y,
                          y[:, L - head - 2:L - 1].flip(1)], dim=1)
    else:
        ypad = y[:, torch.as_tensor(reflect_index(L, head), device=y.device)]
    return F.pad(ypad, (0, max(0, length - ypad.shape[1])))


def bank_matrix(p: CQTParams) -> np.ndarray:
    """(n_fft, 2*bpo) float32 [cos | sin] analysis matrix."""
    bank = kernel_bank(p)
    return np.ascontiguousarray(
        np.concatenate([bank["k_cos"], bank["k_sin"]], axis=1))


def octave_response(ypad: torch.Tensor, starts, kmat: torch.Tensor,
                    scales: torch.Tensor) -> torch.Tensor:
    """(B, Lpad) padded octave stream -> (B, bpo, T) log1p responses of
    the windows beginning at `starts` (float32 throughout)."""
    n_fft = kmat.shape[0]
    bpo = kmat.shape[1] // 2
    idx = (torch.as_tensor(starts, device=ypad.device)[:, None]
           + torch.arange(n_fft, device=ypad.device)[None, :])
    frames = ypad[:, idx].float()                       # (B, T, n_fft)
    r = frames @ kmat                                   # (B, T, 2*bpo)
    c, s = r[..., :bpo], r[..., bpo:]
    mag = torch.sqrt(c * c + s * s) * scales
    return torch.log1p(mag).transpose(1, 2)


def cqt(y: torch.Tensor, p: CQTParams, *,
        stream_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Batched plain-PyTorch log1p-CQT: (B, L) -> (B, n_bins, T)."""
    if y.ndim == 1:
        y = y[None]
    in_scale = input_scale(y)
    n_fft = kernel_bank(p)["n_fft"]
    head = n_fft // 2
    kmat = torch.as_tensor(bank_matrix(p), device=y.device)
    n_frames = 1 + y.shape[1] // p.hop
    cur = y if y.dtype == torch.int16 else y.float()
    octs = []
    for o in range(p.octaves):
        if o > 0:
            cur = downsample2(cur, decimation_taps(o, in_scale),
                              out_dtype=stream_dtype)
        starts = _frame_starts(p.hop, o, n_frames)
        ypad = pad_stream(cur, head, starts[-1] + n_fft)
        scales = torch.as_tensor(octave_scales(p, o, in_scale),
                                 device=y.device)
        octs.append(octave_response(ypad, starts, kmat, scales))
    # octave o analyzes bins [n_bins - (o+1)*bpo : n_bins - o*bpo]
    return torch.cat(octs[::-1], dim=1)
