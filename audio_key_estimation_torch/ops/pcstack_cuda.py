"""The equivariant pitch-class stacks on the card: csrc/pcconv.cu.

An eval-mode PitchClass2PitchClass ConvStack (equivariant, kernel 7) is
a chain of EquivariantConvs with same_depth_padding, each 12 x 7 over
the 12 pitch classes (circular on pitch, zero-padded by 3 on time) ->
BatchNorm -> leaky-ReLU; a residual one (`--resblock`) is a stem and
blocks of two such convs, the block's second adding the block's input
before its leaky-ReLU (models/blocks.py ConvStack, ResBlock). `pc_stack`
runs either as one launch a conv in IEEE float32 on the CUDA cores (the
kernel replaces no Pallas kernel: the JAX package leaves these convs to
XLA). Each conv takes the module's own weight, permuted once per call
to (cin, 7, 12, cout), its bias, and BatchNorm as a per-channel (scale,
shift) applied in the kernel's epilogue ((sum + bias) * scale + shift);
activations stay NCHW float32 and no wrapped tensor is written.

`pcconv` launches the kernel for a CUDA tensor (or raises) and runs its
plain PyTorch version only for a CPU tensor; `pcconv.launches` counts
kernel launches. `pcconv_plain` and `pc_stack_plain` compute the same
functions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build
from .equivariant import wrap_pitch_classes
from .stack_epilogue import LEAKY_SLOPE, fold_bn_affine

KERNEL = 7
PITCH_CLASSES = 12
# (cin, cout, adds the block's input) at the published widths (n_filters
# 4): a plain stack's layer 0 (1 -> 4, 4 -> 4) and layer 1 (12 -> 16, 16
# -> 16); a residual stack's stems (1 -> 4, 12 -> 16) and blocks (4 -> 8
# -> 4, 16 -> 32 -> 16)
CONVS = ((1, 4, False), (4, 4, False), (12, 16, False), (16, 16, False),
         (4, 8, False), (8, 4, True), (16, 32, False), (32, 16, True))
STACK_DTYPES = (torch.float32,)


class Conv(NamedTuple):
    """One conv's operands, float32: weight (cin, 7, 12, cout); bias,
    BatchNorm's scale and shift (cout,)."""
    weight: torch.Tensor
    bias: torch.Tensor
    scale: torch.Tensor
    shift: torch.Tensor


def operands(conv, bn) -> Conv:
    """An EquivariantConv and its eval BatchNorm as the kernel's
    operands."""
    s, t = fold_bn_affine(bn.weight, bn.bias, bn.running_mean,
                          bn.running_var, bn.eps)
    p = conv.conv2d
    return Conv(p.weight.float().permute(1, 3, 2, 0).contiguous(),
                p.bias.float().contiguous(), s.contiguous(), t.contiguous())


def pcconv_plain(x: torch.Tensor, c: Conv,
                 skip: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the kernel: x (B, cin, 12, T) -> (B, cout, 12, T),
    leaky((conv(x) + bias) * scale + shift (+ skip)), in x's dtype."""
    y = F.conv2d(wrap_pitch_classes(x, PITCH_CLASSES),
                 c.weight.permute(3, 0, 2, 1), c.bias,
                 padding=(0, KERNEL // 2))
    y = y * c.scale[:, None, None] + c.shift[:, None, None]
    if skip is not None:
        y = y + skip
    return F.leaky_relu(y, LEAKY_SLOPE)


def pcconv(x: torch.Tensor, c: Conv,
           skip: torch.Tensor | None = None) -> torch.Tensor:
    """One conv of a pitch-class stack (the kernel on CUDA, plain on CPU):
    x (B, cin, 12, T) float32 NCHW, T >= 1; skip (B, cout, 12, T) for a
    residual block's second conv. Returns (B, cout, 12, T) float32."""
    if x.is_cpu:
        return pcconv_plain(x, c, skip)
    if not x.is_cuda:
        raise ValueError(f"pcconv: unsupported device {x.device}")
    cin, cout = c.weight.shape[0], c.weight.shape[-1]
    shape = (x.shape[0], cout, *x.shape[2:]) if x.dim() == 4 else None
    tensors = (x, *c) + (() if skip is None else (skip,))
    if (x.dim() != 4 or x.shape[1] != cin or x.shape[2] != PITCH_CLASSES
            or (cin, cout, skip is not None) not in CONVS
            or tuple(c.weight.shape) != (cin, KERNEL, PITCH_CLASSES, cout)
            or any(v.shape != (cout,) for v in c[1:])
            or (skip is not None and tuple(skip.shape) != shape)
            or any(t.dtype != torch.float32 or not t.is_contiguous()
                   for t in tensors)):
        raise ValueError(
            f"pcconv: unsupported x {x.dtype} {tuple(x.shape)}, weight "
            f"{c.weight.dtype} {tuple(c.weight.shape)}, skip "
            f"{None if skip is None else tuple(skip.shape)}")
    y = _build.op("pcconv")(x, c.weight, c.bias, c.scale, c.shift, skip)
    pcconv.launches += 1
    return y


pcconv.launches = 0


def residual(convs) -> bool:
    """Whether `convs` are a residual stack's (a stem cin -> f, then
    blocks f -> 2f -> f) rather than a plain one's (cin -> f, then f ->
    f): a residual stack's first block widens."""
    return len(convs) > 1 and convs[1].weight.shape[-1] \
        != convs[0].weight.shape[-1]


def _stack(x: torch.Tensor, convs, conv) -> torch.Tensor:
    if not residual(convs):
        for c in convs:
            x = conv(x, c)
        return x
    h = conv(x, convs[0])
    for first, second in zip(convs[1::2], convs[2::2]):
        h = conv(conv(h, first), second, h)
    return h


def pc_stack(x: torch.Tensor, convs) -> torch.Tensor:
    """A pitch-class ConvStack's eval forward: x (B, cin, 12, T) float32
    -> (B, f, 12, T), one pcconv launch a conv. convs: the plain stack's
    convs in order, or the residual stack's stem and then each block's
    first and second conv, as `operands` gives them."""
    return _stack(x.contiguous(), convs, pcconv)


def pc_stack_plain(x: torch.Tensor, convs) -> torch.Tensor:
    return _stack(x, convs, pcconv_plain)
