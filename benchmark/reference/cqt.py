"""The plain log1p-CQT the port implements, in plain PyTorch.

A frozen copy of the algorithm of the port's plain front end (the JAX
package's fused front end, `ops/cqt.py::cqt` in both packages): the
top-octave kernel bank, the 49-tap Kaiser half-band cascade with each
decimated stream stored at `stream_dtype` (bfloat16 in the benchmark's
configurations) and accumulated in float32, centred frames of the
reflect-padded stream, the [cos | sin] product, magnitude, scale and
log1p. Raw int16 PCM stays int16: 1/32768 folds into octave 0's scales
and the first decimation's taps. Rows are computed in blocks so that the
gathered frames stay small.

Output (B, octaves * bins_per_octave, T), T = 1 + L // hop, bins
ascending in frequency.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

C1_HZ = 32.70319566257483   # librosa note_to_hz('C1')
ROW_BLOCK = 32              # rows of a block: (32, T, n_fft) frames at most


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


@functools.lru_cache(maxsize=16)
def kernel_bank(sr: int, bins_per_octave: int, octaves: int,
                fmin: float = C1_HZ) -> dict:
    """Top-octave bank: conjugated, L1-normalized, periodic-hann-windowed
    exponentials of floor(Q sr / f) samples, each placed at
    (n_fft - len) // 2 of the n_fft window; scales sqrt(Q sr / f)."""
    bpo = bins_per_octave
    q = 1.0 / (2.0 ** (1.0 / bpo) - 1.0)
    top0 = bpo * octaves - bpo
    freqs = fmin * 2.0 ** ((top0 + np.arange(bpo)) / bpo)
    lengths = q * sr / freqs
    n_fft = _next_pow2(int(math.ceil(lengths.max())))
    k = np.zeros((n_fft, bpo), np.complex128)
    for i, (f, flen) in enumerate(zip(freqs, lengths)):
        ilen = int(np.floor(flen))
        w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(ilen) / ilen)
        w /= w.sum()
        t = np.arange(ilen) - ilen // 2
        sig = w * np.exp(-2j * np.pi * f * t / sr)
        off = (n_fft - ilen) // 2
        k[off:off + ilen, i] = sig
    mat = np.concatenate([k.real, k.imag], axis=1).astype(np.float32)
    return {"matrix": np.ascontiguousarray(mat),
            "scales": np.sqrt(lengths).astype(np.float32), "n_fft": n_fft}


@functools.lru_cache(maxsize=1)
def halfband_taps(num_taps: int = 49) -> np.ndarray:
    """Kaiser (beta 8) windowed-sinc half-band lowpass, unity DC gain."""
    n = np.arange(num_taps) - (num_taps - 1) / 2
    h = np.sinc(n / 2) / 2
    w = np.i0(8.0 * np.sqrt(np.clip(1 - (2 * n / (num_taps - 1)) ** 2, 0, 1)))
    h = h * (w / np.i0(8.0))
    return (h / h.sum()).astype(np.float32)


def frame_starts(hop: int, octave: int, n_frames: int) -> list[int]:
    """Frame t of octave o is centred at floor(t * hop / 2**o + 0.5): the
    window start in the stream reflect-padded by n_fft // 2."""
    return [math.floor(t * hop / 2 ** octave + 0.5) for t in range(n_frames)]


def decimate(y: torch.Tensor, taps: np.ndarray, out_dtype) -> torch.Tensor:
    """out[k] = sum_j taps[j] y[2k + j - 24], y zero outside, summed in
    float32, stored at out_dtype: (B, L) -> (B, (L - 1) // 2 + 1)."""
    w = torch.as_tensor(taps, device=y.device)
    pad = w.shape[0] // 2
    out = F.conv1d(y.float()[:, None], w[None, None], stride=2, padding=pad)
    return out[:, 0].to(out_dtype)


def reflect_pad(y: torch.Tensor, head: int, length: int) -> torch.Tensor:
    """Reflect-pad by (head, head + 1) (numpy 'reflect', repeated for
    short streams), then zero-extend to `length`; keeps the dtype."""
    L = y.shape[1]
    idx = torch.as_tensor(np.pad(np.arange(L), (head, head + 1),
                                 mode="reflect"), device=y.device)
    ypad = y[:, idx]
    return F.pad(ypad, (0, max(0, length - ypad.shape[1])))


def response(ypad: torch.Tensor, starts, kmat: torch.Tensor,
             scales: torch.Tensor) -> torch.Tensor:
    """(B, Lpad) padded stream -> (B, bpo, T) log1p magnitudes, float32."""
    n_fft, bpo = kmat.shape[0], kmat.shape[1] // 2
    idx = (torch.as_tensor(starts, device=ypad.device)[:, None]
           + torch.arange(n_fft, device=ypad.device)[None, :])
    r = ypad[:, idx].float() @ kmat
    c, s = r[..., :bpo], r[..., bpo:]
    return torch.log1p(torch.sqrt(c * c + s * s) * scales).transpose(1, 2)


def cqt_block(y: torch.Tensor, sr: int, hop: int, bins_per_octave: int,
              octaves: int, stream_dtype) -> torch.Tensor:
    """The log1p-CQT of a (B, L) int16 or float batch, all rows at once."""
    bank = kernel_bank(sr, bins_per_octave, octaves)
    n_fft = bank["n_fft"]
    head = n_fft // 2
    raw = y.dtype == torch.int16
    if not raw and not y.dtype.is_floating_point:
        raise ValueError(f"raw PCM must be int16, got {y.dtype}")
    in_scale = 1.0 / 32768.0 if raw else 1.0
    kmat = torch.as_tensor(bank["matrix"], device=y.device)
    n_frames = 1 + y.shape[1] // hop
    cur = y if raw else y.float()
    octs = []
    for o in range(octaves):
        if o > 0:
            taps = halfband_taps() * np.float32(in_scale if o == 1 else 1.0)
            cur = decimate(cur, taps, stream_dtype)
        starts = frame_starts(hop, o, n_frames)
        ypad = reflect_pad(cur, head, starts[-1] + n_fft)
        scales = bank["scales"] * (
            (in_scale if o == 0 else 1.0) * 2.0 ** (o / 2))
        octs.append(response(ypad, starts, kmat,
                             torch.as_tensor(scales, device=y.device)))
    return torch.cat(octs[::-1], dim=1)


def cqt(y: torch.Tensor, *, sr: int, hop: int, bins_per_octave: int,
        octaves: int, stream_dtype=torch.bfloat16,
        rows: int = ROW_BLOCK) -> torch.Tensor:
    """The batch's log1p-CQT, computed `rows` rows at a time."""
    return torch.cat([cqt_block(y[i:i + rows], sr, hop, bins_per_octave,
                                octaves, stream_dtype)
                      for i in range(0, y.shape[0], rows)])
