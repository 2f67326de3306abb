"""PyTorch building blocks for PitchClassNet (the default variant).

Parameter names follow the reference's torch modules, so a reference
`best_model.pt` loads with `load_state_dict` (keys per the JAX package's
`models/torch_port.py:6-11`): convs and BatchNorms hold `weight`, `bias`,
`running_mean`, `running_var`; an equivariant conv nests its conv as
`.conv2d`; a ConvStack is the reference's `layer` Sequential (conv, BN,
LeakyReLU, ...). BatchNorm keeps no `num_batches_tracked`.

Initialization matches torch's Conv2d default (and the JAX package's
`_init_conv`): weights and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
drawn from an explicit torch.Generator.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import convstack_cuda as CS
from ..ops import equivariant as eqv
from ..ops.convstack_cuda import LEAKY_SLOPE


def _uniform(shape, bound: float, generator: torch.Generator) -> torch.Tensor:
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


class ConvParams(nn.Module):
    """The weight (and bias) of one convolution, torch-default init."""

    def __init__(self, weight_shape, fan_in: int, out_ch: int,
                 generator: torch.Generator, bias: bool = True):
        super().__init__()
        bound = 1.0 / math.sqrt(fan_in)
        self.weight = nn.Parameter(_uniform(weight_shape, bound, generator))
        self.bias = (nn.Parameter(_uniform((out_ch,), bound, generator))
                     if bias else None)


class CircularConv(ConvParams):
    """Conv2d with torch circular padding (Pitch2Pitch convs, pool_semi)."""

    def __init__(self, in_ch, out_ch, kernel, generator, stride=(1, 1),
                 circular_pad=None):
        kh, kw = kernel
        super().__init__((out_ch, in_ch, kh, kw), in_ch * kh * kw, out_ch,
                         generator)
        self.stride = tuple(stride)
        self.circular_pad = circular_pad

    def forward(self, x):
        return eqv.circular_conv2d(x, self.weight, self.bias,
                                   stride=self.stride,
                                   circular_pad_hw=self.circular_pad)


class ZeroPadConv(ConvParams):
    """Plain Conv2d with zero padding (the genre head)."""

    def __init__(self, in_ch, out_ch, kernel, generator, padding=(0, 0)):
        kh, kw = kernel
        super().__init__((out_ch, in_ch, kh, kw), in_ch * kh * kw, out_ch,
                         generator)
        self.padding = tuple(padding)

    def forward(self, x):
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        padding=self.padding)


class EquivariantConv(nn.Module):
    """EquivariantPitchClassConvolutionSimple (reference models.py:22-51)."""

    def __init__(self, in_ch, out_ch, kernel_depth, generator,
                 same_depth_padding=False, pitch_classes=12):
        super().__init__()
        self.conv2d = ConvParams(
            (out_ch, in_ch, pitch_classes, kernel_depth),
            pitch_classes * kernel_depth * in_ch, out_ch, generator)
        self.same_depth_padding = same_depth_padding

    def forward(self, x):
        return eqv.equivariant_pc_conv(
            x, self.conv2d.weight, self.conv2d.bias,
            same_depth_padding=self.same_depth_padding)


class ThirdUpsample(ConvParams):
    """ConvTranspose2d((3,1), stride (3,1)) semitone->third (models.py:325);
    weight (in, out, 3, 1)."""

    def __init__(self, in_ch, out_ch, generator):
        super().__init__((in_ch, out_ch, 3, 1), 3 * in_ch, out_ch, generator)

    def forward(self, x):
        return eqv.third_upsample(x, self.weight, self.bias)


class BatchNorm(nn.Module):
    """torch BatchNorm2d semantics (momentum 0.1, eps 1e-5) without the
    num_batches_tracked counter, so state_dicts match the JAX export."""

    def __init__(self, features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        if self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, True, self.momentum,
                                self.eps)
        dt = x.dtype
        return F.batch_norm(x, self.running_mean.to(dt),
                            self.running_var.to(dt), self.weight.to(dt),
                            self.bias.to(dt), False, 0.0, self.eps)


def leaky_relu(x):
    return F.leaky_relu(x, LEAKY_SLOPE)


class ConvStack(nn.Module):
    """Stack of (conv, BatchNorm, LeakyReLU) x conv_layers.

    equivariant=True gives PitchClass2PitchClass (models.py:168-203),
    False gives Pitch2Pitch (models.py:205-243). `layer` mirrors the
    reference's Sequential indices. With fused_serving, an eval-mode
    Pitch2Pitch stack at kernel C's geometry runs through
    ops/convstack_cuda.py (the JAX package's `_use_fused` gate, without
    its TPU lane constraints).
    """

    def __init__(self, in_ch, out_ch, kernel_size, conv_layers, equivariant,
                 generator, fused_serving=False):
        super().__init__()
        mods = []
        for i in range(conv_layers):
            cin = in_ch if i == 0 else out_ch
            if equivariant:
                conv = EquivariantConv(cin, out_ch, kernel_size, generator,
                                       same_depth_padding=True)
            else:
                conv = CircularConv(cin, out_ch, (kernel_size, kernel_size),
                                    generator)
            mods += [conv, BatchNorm(out_ch), nn.LeakyReLU(LEAKY_SLOPE)]
        self.layer = nn.ModuleList(mods)
        self.cins = [in_ch] + [out_ch] * (conv_layers - 1)
        self.out_ch = out_ch
        self.kernel_size = kernel_size
        self.equivariant = equivariant
        self.fused_serving = fused_serving

    def use_fused(self, x: torch.Tensor) -> bool:
        """Eval-only dispatch to kernel C: plain (non-equivariant),
        kernel-7, 8-output stacks with <= 8 channels, T >= 3 and H >= 3."""
        return (self.fused_serving and not self.training
                and not self.equivariant and self.kernel_size == CS.KERNEL
                and self.out_ch == CS.C
                and CS.supported_geometry(x.shape[2], x.shape[3], self.cins))

    def folded_layers(self):
        """[(weight, bias)] with each BatchNorm folded in, float32."""
        convs, bns = self.layer[0::3], self.layer[1::3]
        return [CS.fold_layer(c.weight, c.bias, b.weight, b.bias,
                              b.running_mean, b.running_var, b.eps)
                for c, b in zip(convs, bns)]

    def forward(self, x):
        if self.use_fused(x):
            return CS.fused_convstack(x, self.folded_layers())
        for m in self.layer:
            x = m(x)
        return x
