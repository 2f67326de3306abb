"""Transposition-equivariant pitch-class ops as plain PyTorch functions.

Counterparts of the JAX package's ops/equivariant.py in the port's NCHW
layout `(batch, channel, pitch, time)` with torch's OIHW weights, so the
reference's state_dict loads unchanged. Circular boundaries are
concatenations (bit-identical to the reference's wrap semantics, and to
the JAX package's, including pads wider than the axis, which
`F.pad(mode="circular")` rejects).

  wrap_pitch_classes   append rows 0..10 below the 12 pitch classes
  equivariant_pc_conv  full-height conv over the wrapped rows
  circular_conv2d      conv with circular padding on pitch and time
  semitone_pool_conv   third-of-semitone -> semitone conv (pool_semi)
  third_upsample       semitone -> third transposed conv (up_sixth)
  pc_to_pitch_tile     tile pitch classes up to the pitch rows
  pc_to_pitch_memory_add  add pitch classes onto the pitch rows (pc2p_mem)
  conv_with_bias       a conv's output plus its bias, rounded as in JAX
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv_with_bias(conv, x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor | None, **kwargs) -> torch.Tensor:
    """conv(x, weight, bias, **kwargs) in x's dtype. In bfloat16 the bias
    is added to the conv's rounded output, as the JAX package adds it (y +
    b.astype(y.dtype)): fused into the conv, the sum would be rounded once
    where the reference rounds twice, and the two bf16 forwards would part
    by an ulp in many outputs."""
    w = weight.to(x.dtype)
    if bias is None or x.dtype != torch.bfloat16:
        return conv(x, w, None if bias is None else bias.to(x.dtype),
                    **kwargs)
    return conv(x, w, None, **kwargs) + bias.to(x.dtype)[:, None, None]


def wrap_pitch_classes(x: torch.Tensor, pitch_classes: int = 12) -> torch.Tensor:
    """Append rows 0..pc-2 below the last row (reference models.py:45)."""
    return torch.cat([x, x[:, :, :pitch_classes - 1]], dim=2)


def equivariant_pc_conv(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor | None = None, *,
                        same_depth_padding: bool = False) -> torch.Tensor:
    """Circular conv over the pitch-class axis (models.py:36-51).

    x (N, Cin, 12, T), weight (Cout, Cin, 12, kd) -> (N, Cout, 12, T'),
    T' = T if same_depth_padding (zero pad kd//2 on time) else T - kd + 1.
    """
    kd = weight.shape[3]
    pad_t = kd // 2 if same_depth_padding else 0
    return conv_with_bias(F.conv2d, wrap_pitch_classes(x, weight.shape[2]),
                          weight, bias, padding=(0, pad_t))


def circular_pad(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Wrap-pad the pitch (dim 2) and time (dim 3) axes by concatenation."""
    if ph > 0:
        x = torch.cat([x[:, :, -ph:], x, x[:, :, :ph]], dim=2)
    if pw > 0:
        x = torch.cat([x[:, :, :, -pw:], x, x[:, :, :, :pw]], dim=3)
    return x


def circular_conv2d(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor | None = None, *,
                    stride: tuple = (1, 1),
                    circular_pad_hw: tuple | None = None) -> torch.Tensor:
    """Conv2d with torch-style circular padding (models.py:221,230,409);
    the pad defaults to (kh//2, kw//2)."""
    kh, kw = weight.shape[2], weight.shape[3]
    ph, pw = circular_pad_hw if circular_pad_hw is not None \
        else (kh // 2, kw // 2)
    return conv_with_bias(F.conv2d, circular_pad(x, ph, pw), weight, bias,
                          stride=stride)


def semitone_pool_conv(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor | None = None) -> torch.Tensor:
    """Third-of-semitone -> semitone learned pooling (models.py:313,337):
    kernel 3, stride (3, 1), circular padding on time only."""
    return circular_conv2d(x, weight, bias, stride=(3, 1),
                           circular_pad_hw=(0, 1))


def third_upsample(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor | None = None) -> torch.Tensor:
    """Semitone -> third-of-semitone ConvTranspose2d((3,1), stride (3,1))
    (models.py:325). weight (Cin, Cout, 3, 1): (N, Cin, P, T) ->
    (N, Cout, 3P, T)."""
    return conv_with_bias(F.conv_transpose2d, x, weight, bias, stride=(3, 1))


def pc_to_pitch_tile(x: torch.Tensor, pitches: int) -> torch.Tensor:
    """Tile pitch-class rows up to `pitches` rows and crop (models.py:140-143)."""
    reps = -(-pitches // x.shape[2])
    return x.repeat(1, 1, reps, 1)[:, :, :pitches]


def pc_to_pitch_memory_add(pitches: torch.Tensor,
                           pitch_classes: torch.Tensor) -> torch.Tensor:
    """Memory variant: add pc features onto pitch features (models.py:151-166).

    Groups of C2 // C1 consecutive channels of `pitch_classes` are summed
    down to the pitch stream's C1 channels, then added over row-major
    blocks of the pitch axis: pitch row r gets pitch-class-stream row
    r // (P // rows) (the reference's reshape semantics).

    pitches       : (N, C1, P, T)
    pitch_classes : (N, C2, rows, T) with C2 % C1 == 0 and P % rows == 0
    """
    n, c1, p, t = pitches.shape
    c2, rows = pitch_classes.shape[1], pitch_classes.shape[2]
    pc = pitch_classes.reshape(n, c1, c2 // c1, rows, t).sum(dim=2)
    out = pitches.reshape(n, c1, rows, p // rows, t) + pc[:, :, :, None]
    return out.reshape(n, c1, p, t)
