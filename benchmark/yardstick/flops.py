"""Useful operations of a served clip or a training step, counted from
the functions' definitions at each clip's own, unpadded length, so that
padding counts as waste and not as work.

`frontend_flops` is a frozen copy of the port bench's analytic count of
the CQT (`audio_key_estimation_torch/bench.py::frontend_flops`). The
model's operations are those `torch.utils.flop_counter.FlopCounterMode`
counts over the reference model the configuration names
(`reference/<reference>.py`, found by `reference.of`) run on one clip of
that length, on the meta device (no arithmetic is done); each distinct
configuration and length is counted once.
"""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from .. import reference
from ..reference import serve as ref_serve
from .roofline import HALFBAND_TAPS, n_fft, stream_lengths


def frontend_flops(*, sr: int, hop: int, bins_per_octave: int, octaves: int,
                   L: int, batch: int = 1) -> float:
    """Useful FLOPs of the CQT of `batch` clips of L samples: per octave
    and clip, n_frames windows of n_fft samples against bins_per_octave
    complex filters, 2 * 2 * bpo * n_fft * n_frames; per decimated output
    sample, the 49-tap half-band FIR, 2 * 49."""
    nfft = n_fft(sr, bins_per_octave, octaves)
    n_frames = 1 + L // hop
    response = 2 * 2 * bins_per_octave * nfft * n_frames * octaves
    decimation = 2 * HALFBAND_TAPS * sum(stream_lengths(L, octaves)[1:])
    return float(batch * (response + decimation))


@functools.lru_cache(maxsize=4096)
def _model_flops(cfg_json: str, frames: int, backward: bool) -> int:
    cfg = json.loads(cfg_json)
    ref = reference.of(cfg)
    weights = {k: torch.empty(s, device="meta", requires_grad=backward)
               for k, s, _, _ in ref.spec(cfg)}
    rows = [cfg["octaves"] * bpo for bpo in ref_serve.bins_of(cfg)]
    mels = [torch.empty(1, r, frames, device="meta") for r in rows]
    seq = torch.full((1,), frames, dtype=torch.int32, device="meta")
    counter = FlopCounterMode(display=False)
    with counter:
        key, tonic = ref.forward(
            weights, cfg, mels, seq, mode="train" if backward else "eval")
        if backward:
            (key.sum() + tonic.sum()).backward()
    return int(counter.get_total_flops())


def model_flops(cfg: dict, frames: int, backward: bool = False) -> int:
    """The model's FLOPs on one clip of `frames` true frames, forward (and
    backward), by FlopCounterMode over the reference model."""
    return _model_flops(json.dumps(cfg, sort_keys=True), int(frames),
                        backward)


def clip_flops(cfg: dict, *, sr: int, hop: int, samples: int) -> float:
    """Front end and model of one served clip of `samples` samples."""
    front = sum(frontend_flops(sr=sr, hop=hop, bins_per_octave=bpo,
                               octaves=cfg["octaves"], L=samples)
                for bpo in ref_serve.bins_of(cfg))
    return front + model_flops(cfg, 1 + samples // hop)
