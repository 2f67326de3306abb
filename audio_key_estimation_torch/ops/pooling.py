"""Octave folding and time pooling (reference models.py:82-106, 349-350),
NCHW counterparts of the JAX package's ops/pooling.py."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def octave_max_pool(x: torch.Tensor, pitch_classes: int = 12) -> torch.Tensor:
    """Fold pitches into pitch classes by max over octaves (models.py:95-106).

    Pads the pitch axis to a multiple of `pitch_classes` with -inf, then
    takes, for each pitch class, the max across all octaves.
    x (N, C, P, T) -> (N, C, pitch_classes, T)
    """
    n, c, p, t = x.shape
    ksize = -(-p // pitch_classes)
    pad = ksize * pitch_classes - p
    if pad:
        x = F.pad(x, (0, 0, 0, pad), value=float("-inf"))
    return x.reshape(n, c, ksize, pitch_classes, t).amax(dim=2)


def time_max_pool(x: torch.Tensor, pool_size: int) -> torch.Tensor:
    """MaxPool2d((1, pool_size)) with torch floor semantics (models.py:349-350)."""
    return F.max_pool2d(x, (1, pool_size))
