"""Exact direct-convolution CQT in float64: the oracle for ops/cqt.py.

The PyTorch counterpart of the JAX package's `ops/cqt_oracle.py`, on an
explicit device so the card can evaluate it at the served size. It is the
textbook constant-Q transform computed the slow, unambiguous way: every bin
gets its own full-rate kernel (length Q*sr/f, periodic hann, L1-normalized,
scale=True sqrt-length scaling — librosa.cqt's conventions) correlated
directly against the reflect-padded full-rate signal at the exact frame
centres t*hop. No multirate downsampling, no pow2 frame windows, no
frame-centre rounding.

O(n_bins * T * kernel_len): at 22050 Hz, 36 bins/octave and 8 octaves the
kernels sum to ~1.8M samples a frame (the lowest ~34.7k), so bins are
evaluated one at a time and the clips in chunks whose gathered windows
stay under 1 GiB. Test-only: no product module imports it.
"""

from __future__ import annotations

import numpy as np
import torch

from .cqt import CQTParams

_CHUNK_BYTES = 1 << 30      # gathered float64 windows per matmul


def _bin_kernel(f: float, flen: float, sr: int) -> tuple[int, np.ndarray]:
    """(integer length, (ilen, 2) float64 [real | imag]) of one bin's
    conjugated, L1-normalized, periodic-hann kernel centred on ilen // 2."""
    ilen = int(np.floor(flen))
    w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(ilen) / ilen)
    w /= w.sum()
    t = np.arange(ilen) - ilen // 2
    k = w * np.exp(-2j * np.pi * f * t / sr)
    return ilen, np.stack([k.real, k.imag], axis=1)


def oracle_cqt(y, p: CQTParams, *, log1p: bool = True,
               device=None) -> torch.Tensor:
    """(B, L) or (L,) waveforms (numpy or torch) -> (B, n_bins, T) float64
    CQT magnitudes (log1p of them by default) on `device` (the input's
    device when None). T = 1 + L // hop, matching ops.cqt.cqt; bins
    ascending in frequency."""
    y = torch.as_tensor(y, device=device).to(torch.float64)
    if y.ndim == 1:
        y = y[None]
    b, L = y.shape
    n_frames = 1 + L // p.hop
    freqs = p.fmin * 2.0 ** (np.arange(p.n_bins) / p.bins_per_octave)
    lengths = p.q * p.sr / freqs

    pad = int(np.ceil(lengths.max() / 2)) + 2
    if pad >= L:
        raise ValueError(
            f"signal too short for oracle reflect pad: need L > {pad}")
    ypad = y[:, torch.as_tensor(np.pad(np.arange(L), pad, mode="reflect"),
                                device=y.device)]

    out = torch.empty(b, p.n_bins, n_frames, dtype=torch.float64,
                      device=y.device)
    span = (n_frames - 1) * p.hop
    for j, (f, flen) in enumerate(zip(freqs, lengths)):
        ilen, k = _bin_kernel(f, flen, p.sr)
        k = torch.from_numpy(k).to(y.device)
        s0 = pad - ilen // 2          # window start of frame 0
        rows = max(1, _CHUNK_BYTES // (n_frames * ilen * 8))
        for c in range(0, b, rows):
            # (rows, T, ilen) full-rate windows around each exact centre
            seg = ypad[c:c + rows, s0:s0 + span + ilen].unfold(1, ilen,
                                                               p.hop)
            r = seg @ k
            out[c:c + rows, j] = torch.hypot(r[..., 0], r[..., 1])
        out[:, j] *= np.sqrt(ilen)
    return torch.log1p(out) if log1p else out
