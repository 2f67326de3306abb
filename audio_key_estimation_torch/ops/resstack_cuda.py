"""The residual Pitch2Pitch stack on the card: csrc/resconv7.cu.

An eval-mode residual ConvStack (`--resblock`, non-equivariant, kernel
7) is a stem conv and blocks of two convs, each 7x7 circular conv ->
BatchNorm -> leaky-ReLU, the block's second adding the block's input
before its leaky-ReLU (models/blocks.py ResBlock). `residual_stack` runs
it as one launch a conv, seven for three blocks, in IEEE float32 on the
CUDA cores (the kernel replaces no Pallas kernel: the JAX package leaves
these convs to XLA). Each conv takes the module's own weight, permuted
once per call to (cin, 7, 7, cout), its bias, and BatchNorm as a
per-channel (scale, shift) applied in the kernel's epilogue
((sum + bias) * scale + shift); activations stay NCHW float32.

`resconv7` launches the kernel for a CUDA tensor (or raises) and runs its
plain PyTorch version only for a CPU tensor; `resconv7.launches` counts
kernel launches. `resconv7_plain` and `residual_stack_plain` compute the
same functions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build
from .equivariant import circular_pad
from .stack_epilogue import LEAKY_SLOPE, fold_bn_affine

KERNEL = 7
# (cin, cout, adds the block's input): the stem, a block's first and
# second conv at the published widths (5 -> 8, 8 -> 16, 16 -> 8)
CONVS = ((5, 8, False), (8, 16, False), (16, 8, True))
STACK_DTYPES = (torch.float32,)


class Conv(NamedTuple):
    """One conv's operands, float32: weight (cin, 7, 7, cout); bias,
    BatchNorm's scale and shift (cout,)."""
    weight: torch.Tensor
    bias: torch.Tensor
    scale: torch.Tensor
    shift: torch.Tensor


def operands(conv, bn) -> Conv:
    """A CircularConv and its eval BatchNorm as the kernel's operands."""
    s, t = fold_bn_affine(bn.weight, bn.bias, bn.running_mean,
                          bn.running_var, bn.eps)
    return Conv(conv.weight.float().permute(1, 2, 3, 0).contiguous(),
                conv.bias.float().contiguous(), s.contiguous(),
                t.contiguous())


def resconv7_plain(x: torch.Tensor, c: Conv,
                   skip: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the kernel: x (B, cin, H, T) float32 -> (B, cout,
    H, T), leaky((conv(x) + bias) * scale + shift (+ skip))."""
    y = F.conv2d(circular_pad(x, 3, 3), c.weight.permute(3, 0, 1, 2),
                 c.bias)
    y = y * c.scale[:, None, None] + c.shift[:, None, None]
    if skip is not None:
        y = y + skip
    return F.leaky_relu(y, LEAKY_SLOPE)


def resconv7(x: torch.Tensor, c: Conv,
             skip: torch.Tensor | None = None) -> torch.Tensor:
    """One conv of a residual stack (the kernel on CUDA, plain on CPU):
    x (B, cin, H, T) float32 NCHW, H and T >= 3; skip (B, cout, H, T) for
    a block's second conv. Returns (B, cout, H, T) float32."""
    if x.is_cpu:
        return resconv7_plain(x, c, skip)
    if not x.is_cuda:
        raise ValueError(f"resconv7: unsupported device {x.device}")
    cin, cout = c.weight.shape[0], c.weight.shape[-1]
    shape = (x.shape[0], cout, *x.shape[2:]) if x.dim() == 4 else None
    tensors = (x, *c) + (() if skip is None else (skip,))
    if (x.dim() != 4 or x.shape[1] != cin or min(x.shape[2:]) < 3
            or (cin, cout, skip is not None) not in CONVS
            or tuple(c.weight.shape) != (cin, KERNEL, KERNEL, cout)
            or any(v.shape != (cout,) for v in c[1:])
            or (skip is not None and tuple(skip.shape) != shape)
            or any(t.dtype != torch.float32 or not t.is_contiguous()
                   for t in tensors)):
        raise ValueError(
            f"resconv7: unsupported x {x.dtype} {tuple(x.shape)}, weight "
            f"{c.weight.dtype} {tuple(c.weight.shape)}, skip "
            f"{None if skip is None else tuple(skip.shape)}")
    y = _build.op("resconv7")(x, c.weight, c.bias, c.scale, c.shift, skip)
    resconv7.launches += 1
    return y


resconv7.launches = 0


def _stack(x: torch.Tensor, convs, conv) -> torch.Tensor:
    h = conv(x, convs[0])
    for first, second in zip(convs[1::2], convs[2::2]):
        h = conv(conv(h, first), second, h)
    return h


def residual_stack(x: torch.Tensor, convs) -> torch.Tensor:
    """A residual ConvStack's eval forward: x (B, cin, H, T) float32 ->
    (B, f, H, T), one resconv7 launch a conv. convs: [stem, then each
    block's first and second conv] as `operands` gives them."""
    return _stack(x, convs, resconv7)


def residual_stack_plain(x: torch.Tensor, convs) -> torch.Tensor:
    return _stack(x, convs, resconv7_plain)
