"""Seeded tonal audio, made on the device in a few large calls.

Each clip is two or three partials on notes of one seeded key (a tonic
and a major or minor scale, MIDI notes 40-84), each with its own
amplitude and phase, plus white noise, as mono PCM16 at the mix's
sample rate. The phase of a partial is taken in float64 from
frac(f * n / sr), so that a 7-minute clip keeps its pitch; the rest is
float32. The same seed gives the same samples.
"""

from __future__ import annotations

import numpy as np
import torch

_SCALES = {"major": (0, 2, 4, 5, 7, 9, 11), "minor": (0, 2, 3, 5, 7, 8, 10)}
ROW_BLOCK = 8


def partials(rng: np.random.Generator, n: int) -> list:
    """n clips' [(frequency Hz, amplitude, phase)] lists and noise levels."""
    out = []
    for _ in range(n):
        tonic = int(rng.integers(12))
        scale = _SCALES["major" if rng.random() < 0.5 else "minor"]
        k = int(rng.integers(2, 4))
        notes = [40 + tonic + scale[int(rng.integers(7))]
                 + 12 * int(rng.integers(4)) for _ in range(k)]
        out.append(([(440.0 * 2.0 ** ((m - 69) / 12.0),
                      float(rng.uniform(0.12, 0.3)),
                      float(rng.uniform(0, 2 * np.pi))) for m in notes],
                    float(rng.uniform(0.01, 0.05))))
    return out


def pcm16_batch(lengths, width: int, sr: int, seed: int,
                device) -> torch.Tensor:
    """(len(lengths), width) int16 on `device`: row i holds a clip of
    lengths[i] samples, zero after it."""
    lengths = [int(n) for n in lengths]
    rng = np.random.default_rng(seed)
    params = partials(rng, len(lengths))
    g = torch.Generator(device=device).manual_seed(seed)
    out = torch.zeros((len(lengths), width), dtype=torch.int16, device=device)
    n = torch.arange(width, dtype=torch.float64, device=device)
    for r0 in range(0, len(lengths), ROW_BLOCK):
        rows = range(r0, min(r0 + ROW_BLOCK, len(lengths)))
        y = torch.randn((len(rows), width), generator=g, device=device)
        y *= torch.tensor([params[i][1] for i in rows],
                          device=device)[:, None]
        for j, i in enumerate(rows):
            for f, amp, phase in params[i][0]:
                cyc = torch.frac(n * (f / sr))
                y[j] += amp * torch.sin(2 * np.pi * cyc + phase).float()
        y = torch.clamp(torch.round(y * 32767.0), -32768, 32767)
        keep = n[None, :] < torch.tensor([lengths[i] for i in rows],
                                         device=device)[:, None]
        out[r0:r0 + len(rows)] = torch.where(keep, y, 0).to(torch.int16)
    return out


def write_wav(path: str, samples: np.ndarray, sr: int) -> None:
    """Mono PCM16 RIFF/WAVE."""
    data = np.ascontiguousarray(samples, "<i2").tobytes()
    head = b"".join([
        b"RIFF", (36 + len(data)).to_bytes(4, "little"), b"WAVE",
        b"fmt ", (16).to_bytes(4, "little"), (1).to_bytes(2, "little"),
        (1).to_bytes(2, "little"), sr.to_bytes(4, "little"),
        (2 * sr).to_bytes(4, "little"), (2).to_bytes(2, "little"),
        (16).to_bytes(2, "little"), b"data", len(data).to_bytes(4, "little")])
    with open(path, "wb") as f:
        f.write(head)
        f.write(data)
