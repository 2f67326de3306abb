"""PyTorch building blocks for PitchClassNet.

Parameter names follow the reference's torch modules, so a reference
`best_model.pt` loads with `load_state_dict` (keys per the JAX package's
`models/torch_port.py:6-11`): convs and BatchNorms hold `weight`, `bias`,
`running_mean`, `running_var`; an equivariant conv nests its conv as
`.conv2d` and the p2pc_conv pool as `.conv`; a ConvStack is the
reference's `layer` Sequential (conv, BN, LeakyReLU, ..., or a stem and
ResBlocks from index 3, or one DenseBlock at index 0). BatchNorm keeps no
`num_batches_tracked`.

Initialization matches torch's Conv2d default (and the JAX package's
`_init_conv`): weights and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
drawn from an explicit torch.Generator.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import equivariant as eqv
from ..ops import pooling
from ..ops.stack_epilogue import LEAKY_SLOPE
from ..ops.stack_kernels import kernel_for
from ..parallel.mesh import all_reduce_
from ..utils.profiling import span


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
    """Plain Conv2d with zero padding (dense-layer convs, the genre head)."""

    def __init__(self, in_ch, out_ch, kernel, generator, padding=(0, 0),
                 bias=True):
        kh, kw = kernel
        super().__init__((out_ch, in_ch, kh, kw), in_ch * kh * kw, out_ch,
                         generator, bias=bias)
        self.padding = tuple(padding)

    def forward(self, x):
        return eqv.conv_with_bias(F.conv2d, x, self.weight, self.bias,
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
    num_batches_tracked counter, so state_dicts match the JAX export.

    In training mode the running statistics take the batch's mean and its
    biased variance over (N, H, W), in float32, as flax's nn.BatchNorm
    does (torch's own BatchNorm2d would take the unbiased variance);
    `update_stats` False leaves them as they are (a recomputation under
    activation checkpointing).

    Under data parallelism (`data_shard`, set by set_data_shard) the
    training-mode statistics are those of the global micro-batch, every
    rank's rows together, as the JAX package's sharded step takes them
    (_GlobalBatchNorm). Eval mode is the same either way."""

    def __init__(self, features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.update_stats = True
        self.data_shard = None      # (rank, world) under data parallelism
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        dt = x.dtype
        if self.training and self.data_shard is not None:
            return self._global_batch_norm(x).to(dt)
        # flax normalizes in float32 (or wider) whatever x's dtype and
        # rounds the output once; a bf16 F.batch_norm would round inside
        xf = x.to(torch.promote_types(dt, torch.float32))
        ft = xf.dtype
        if self.training:
            if self.update_stats:
                with torch.no_grad():
                    var, mean = torch.var_mean(xf.float(), dim=(0, 2, 3),
                                               correction=0)
                    m = self.momentum
                    self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                    self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            return F.batch_norm(xf, None, None, self.weight.to(ft),
                                self.bias.to(ft), True, 0.0,
                                self.eps).to(dt)
        return F.batch_norm(xf, self.running_mean.to(ft),
                            self.running_var.to(ft), self.weight.to(ft),
                            self.bias.to(ft), False, 0.0, self.eps).to(dt)

    def _global_batch_norm(self, x):
        """Normalize by the global micro-batch's statistics
        (_GlobalBatchNorm); the running statistics take its mean and
        biased variance, identical on every rank."""
        y, mean, var = _GlobalBatchNorm.apply(
            x.to(torch.promote_types(x.dtype, torch.float32)), self.weight,
            self.bias, self.eps)
        if self.update_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        return y


class _GlobalBatchNorm(torch.autograd.Function):
    """Training-mode BatchNorm over every rank's rows, in float32 (float64
    for a float64 x), as SyncBatchNorm computes it (and on the CPU too): the per-channel count
    and sum all-reduced, then the sum of squared deviations from the
    global mean (two passes, no cancellation); y = (x - mean) * w /
    sqrt(var + eps) + b with the biased variance. The backward
    all-reduces the per-channel sums of dy and dy * (x - mean) once and
    applies BatchNorm's fused input gradient; the weight and bias
    gradients stay this rank's (DDP sums them over the ranks)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        c = x.shape[1]
        s = torch.cat([x.sum(dim=(0, 2, 3)),
                       x.new_full((1,), x.numel() // c)])
        all_reduce_(s)
        n = s[c:]
        mean = s[:c] / n
        xmu = x - mean[None, :, None, None]
        var = all_reduce_((xmu * xmu).sum(dim=(0, 2, 3))) / n
        invstd = torch.rsqrt(var + eps)
        y = xmu * (invstd * weight)[None, :, None, None] \
            + bias[None, :, None, None]
        ctx.save_for_backward(xmu, invstd, weight, n)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        xmu, invstd, weight, n = ctx.saved_tensors
        c = xmu.shape[1]
        local = torch.cat([dy.sum(dim=(0, 2, 3)),
                           (dy * xmu).sum(dim=(0, 2, 3))])
        grad_bias, grad_weight = local[:c], local[c:] * invstd
        g = all_reduce_(local.clone()) / n
        grad_x = (dy - g[:c][None, :, None, None]
                  - xmu * (g[c:] * invstd * invstd)[None, :, None, None]) \
            * (invstd * weight)[None, :, None, None]
        return grad_x, grad_weight, grad_bias, None


def leaky_relu(x):
    return F.leaky_relu(x, LEAKY_SLOPE)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            shard: tuple | None = None) -> torch.Tensor:
    """Inverted dropout (flax nn.Dropout, F.dropout): keep each element
    with probability 1 - rate, scaled by 1 / (1 - rate), the mask drawn
    from `generator`, which must live on x's device. With shard (rank,
    world), x is one rank's rows of a global micro-batch: the mask of
    the whole micro-batch is drawn (every rank's generator holds one
    state) and this rank keeps its rows, so the masks are those of one
    process over the global micro-batch."""
    if generator is None:
        raise RuntimeError("dropout in training mode needs an explicit "
                           "generator (PitchClassNet.set_dropout_generator)")
    if shard is None:
        keep = torch.empty_like(x).bernoulli_(1.0 - rate, generator=generator)
    else:
        rank, world = shard
        n = x.shape[0]
        keep = x.new_empty((n * world, *x.shape[1:])).bernoulli_(
            1.0 - rate, generator=generator)[rank * n:(rank + 1) * n]
    return x * keep / (1.0 - rate)


def set_data_shard(model: nn.Module, shard: tuple | None) -> None:
    """Train `model` as rank `shard[0]` of `shard[1]` data-parallel
    ranks (None: alone): its BatchNorms take the global micro-batch's
    statistics and its dropout masks are the global micro-batch's."""
    for m in model.modules():
        if isinstance(m, (BatchNorm, DenseLayer)):
            m.data_shard = shard


class ResBlock(nn.Module):
    """2-conv residual block, circular padding (models.py:402-427)."""

    def __init__(self, kernel_size, num_filters, equivariant, generator):
        super().__init__()
        k, f = kernel_size, num_filters
        if equivariant:
            self.conv1 = EquivariantConv(f, 2 * f, k, generator,
                                         same_depth_padding=True)
            self.conv2 = EquivariantConv(2 * f, f, k, generator,
                                         same_depth_padding=True)
        else:
            self.conv1 = CircularConv(f, 2 * f, (k, k), generator)
            self.conv2 = CircularConv(2 * f, f, (k, k), generator)
        self.b1 = BatchNorm(2 * f)
        self.b2 = BatchNorm(f)

    def forward(self, x):
        r = leaky_relu(self.b1(self.conv1(x)))
        return leaky_relu(x + self.b2(self.conv2(r)))


class DenseLayer(nn.Module):
    """DenseNet bottleneck layer (models.py:456-582): norm1 -> LeakyReLU
    -> 1x1 conv -> norm2 -> ReLU -> kxk conv. Non-equivariant convs are
    bias-free with zero padding; equivariant convs carry biases."""

    def __init__(self, in_ch, growth, bn_size, kernel_size, equivariant,
                 generator, drop_rate=0.0):
        super().__init__()
        mid, k = bn_size * growth, kernel_size
        self.norm1 = BatchNorm(in_ch)
        if equivariant:
            self.conv1 = EquivariantConv(in_ch, mid, 1, generator)
        else:
            self.conv1 = ZeroPadConv(in_ch, mid, (1, 1), generator,
                                     bias=False)
        self.norm2 = BatchNorm(mid)
        if equivariant:
            self.conv2 = EquivariantConv(mid, growth, k, generator,
                                         same_depth_padding=True)
        else:
            self.conv2 = ZeroPadConv(mid, growth, (k, k), generator,
                                     padding=(k // 2, k // 2), bias=False)
        self.drop_rate = drop_rate
        self.generator = None   # set by PitchClassNet.set_dropout_generator
        self.data_shard = None  # set by set_data_shard

    def forward(self, x):
        y = self.conv1(leaky_relu(self.norm1(x)))
        y = self.conv2(F.relu(self.norm2(y)))
        # dropout on the new features (models.py:516-517), training only
        if not (self.training and self.drop_rate > 0):
            return y
        return dropout(y, self.drop_rate, self.generator, self.data_shard)


class DenseBlock(nn.Module):
    """Densely-connected block (models.py:584-648): layer i sees the
    block input and every earlier layer's features; multi_path gives
    layer i kernel 2i + 3."""

    def __init__(self, num_layers, in_ch, bn_size, growth, kernel_size,
                 equivariant, generator, multi_path=False, drop_rate=0.0):
        super().__init__()
        for i in range(num_layers):
            k = 2 * i + 3 if multi_path else kernel_size
            self.add_module(f"denselayer{i + 1}", DenseLayer(
                in_ch + i * growth, growth, bn_size, k, equivariant,
                generator, drop_rate))

    def forward(self, x):
        features = [x]
        for layer in self.children():
            features.append(layer(torch.cat(features, dim=1)))
        return torch.cat(features, dim=1)


class ConvStack(nn.Module):
    """Stack of (conv, BatchNorm, LeakyReLU) x conv_layers, or of
    residual or dense blocks (models.py:168-243).

    equivariant=True gives PitchClass2PitchClass, False gives
    Pitch2Pitch. `layer` mirrors the reference's Sequential indices: conv
    i at 3i (BN 3i + 1); with resblock a conv/BN stem at 0, 1 and the
    ResBlocks from 3; with denseblock one DenseBlock at 0. `kernel` is
    the hand kernel built for the stack's structure (ops/stack_kernels.py:
    kernel C for a plain Pitch2Pitch stack at its geometry, resconv7 for
    a residual one at the published widths, pcconv for a plain or
    residual pitch-class stack at the published widths), or None;
    forward runs it where `runs_kernel` says.

    Each forward is one `akx.stack` span, kernel or not, whose record
    carries `convs` (the convolutions the stack runs: conv_layers plain,
    a stem and two a block residual, two a layer dense) and `res_blocks`;
    a stack whose kernel is `recorded` also carries that count
    (`hand_kernel` for resconv7, `pc_kernel` for pcconv): 1 where
    forward ran it (the kernel on a card, its plain version on the CPU),
    else 0.
    """

    def __init__(self, in_ch, out_ch, kernel_size, conv_layers, equivariant,
                 generator, fused_serving=False, resblock=False,
                 denseblock=False, drop_rate=0.0):
        super().__init__()

        def conv(cin, cout):
            if equivariant:
                return EquivariantConv(cin, cout, kernel_size, generator,
                                       same_depth_padding=True)
            return CircularConv(cin, cout, (kernel_size, kernel_size),
                                generator)

        self.out_channels = out_ch
        if resblock:
            mods = [conv(in_ch, out_ch), BatchNorm(out_ch),
                    nn.LeakyReLU(LEAKY_SLOPE)]
            mods += [ResBlock(kernel_size, out_ch, equivariant, generator)
                     for _ in range(conv_layers)]
        elif denseblock:
            mods = [DenseBlock(conv_layers, in_ch, max(in_ch // 2, 1),
                               out_ch, kernel_size, equivariant, generator,
                               drop_rate=drop_rate)]
            self.out_channels = in_ch + conv_layers * out_ch
        else:
            mods = []
            for i in range(conv_layers):
                mods += [conv(in_ch if i == 0 else out_ch, out_ch),
                         BatchNorm(out_ch), nn.LeakyReLU(LEAKY_SLOPE)]
        self.layer = nn.ModuleList(mods)
        self.cins = [in_ch] + [out_ch] * (conv_layers - 1)
        self.fused_serving = fused_serving
        self.span_counts = {
            "convs": (1 + 2 * conv_layers if resblock else
                      2 * conv_layers if denseblock else conv_layers),
            "res_blocks": conv_layers if resblock else 0}
        self.kernel = kernel_for(
            "residual" if resblock else "dense" if denseblock else "plain",
            equivariant, kernel_size, self.cins, out_ch)

    def runs_kernel(self, x: torch.Tensor) -> bool:
        """Whether forward runs `kernel` on x: fused_serving on, eval
        mode, a dtype the kernel takes, H >= 3 and T >= 3 (on shorter
        axes the JAX package's concat wrap pads by fewer rows than the
        kernels' circular pad of 3, so the module path runs there)."""
        return (self.kernel is not None and self.fused_serving
                and not self.training and x.dtype in self.kernel.dtypes
                and x.shape[2] >= 3 and x.shape[3] >= 3)

    def conv_pairs(self) -> list:
        """The (conv, BatchNorm) pairs in order: each plain layer's, or
        the stem's and then each residual block's two."""
        blocks = [m for m in self.layer if isinstance(m, ResBlock)]
        if not blocks:
            return list(zip(self.layer[0::3], self.layer[1::3]))
        return [(self.layer[0], self.layer[1])] + [
            p for b in blocks for p in ((b.conv1, b.b1), (b.conv2, b.b2))]

    def forward(self, x):
        k, take = self.kernel, self.runs_kernel(x)
        counts = self.span_counts
        if k is not None and k.recorded:
            counts = {**counts, k.recorded: int(take)}
        with span("akx.stack", tally=False, **counts):
            if take:
                return k.run(x, k.operands(self.conv_pairs()))
            for m in self.layer:
                x = m(x)
            return x


class OctaveConvPool(nn.Module):
    """Learned octave folding, flag --p2pc_conv (models.py:108-133): a
    conv dilated by 12 on the pitch axis, BatchNorm, LeakyReLU."""

    def __init__(self, in_ch, pitches_in, generator):
        super().__init__()
        ksize = -(-pitches_in // 12)
        self.conv = ConvParams((in_ch, in_ch, ksize, 1), ksize * in_ch, in_ch,
                               generator)
        self.bn = BatchNorm(in_ch)

    def forward(self, x):
        y = pooling.octave_dilated_conv(x, self.conv.weight, self.conv.bias)
        return leaky_relu(self.bn(y))
