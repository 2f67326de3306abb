"""Octave folding and time pooling (reference models.py:82-133, 349-350,
721-722), NCHW counterparts of the JAX package's ops/pooling.py."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .equivariant import conv_with_bias


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


def octave_dilated_conv(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor | None = None, *,
                        pitch_classes: int = 12) -> torch.Tensor:
    """Learned octave folding: a conv dilated by `pitch_classes` on the
    pitch axis (models.py:108-133, flag p2pc_conv).

    x (N, Cin, P, T), weight (Cout, Cin, ksize, kd) -> (N, Cout,
    pitch_classes, T - kd + 1). The reference pads the pitch axis up to
    ksize * pitch_classes with -inf, which would poison a linear conv; as
    the JAX package does, the pad here is zeros (empty at the default
    geometry, where P divides by 12).
    """
    pad = weight.shape[2] * pitch_classes - x.shape[2]
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    return conv_with_bias(F.conv2d, x, weight, bias,
                          dilation=(pitch_classes, 1))


def time_max_pool(x: torch.Tensor, pool_size: int) -> torch.Tensor:
    """MaxPool2d((1, pool_size)) with torch floor semantics (models.py:349-350)."""
    return F.max_pool2d(x, (1, pool_size))


def sliding_time_max(x: torch.Tensor, window: int) -> torch.Tensor:
    """Max over every `window` consecutive frames, stride 1, VALID
    (the local head, models.py:721-722): (N, C, H, T) -> (N, C, H,
    T - window + 1), empty on the time axis when T < window."""
    if x.shape[3] < window:
        return x[..., :0]
    return F.max_pool2d(x, (1, window), stride=1)
