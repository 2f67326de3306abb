"""PitchClassNet with dense stacks (`train_model.py --denseblock`) as
plain PyTorch functions.

flo-stilz/Audio-Key-Estimation, `models.py:456-648` (`_DenseLayer`,
`_DenseLayerEquivariant`, `DenseBlock`, `DenseBlockEquivariant`): every
ConvStack is one DenseBlock of `conv_layers` layers. Layer i sees the
concatenation of the block's input and every earlier layer's features,

    y_i = conv_k(ReLU(BN2(conv_1(leaky(BN1(cat(x, y_1 .. y_{i-1})))))))

where conv_1 is a bottleneck to bn_size * growth channels (bn_size =
max(cin // 2, 1) of the block's input cin, growth = n_filters) and
conv_k gives growth channels; the block outputs cat(x, y_1 .. y_n). In a
Pitch2Pitch stack both convs are bias-free and zero-padded (1 x 1, then
k x k with k // 2 zeros on each side); in a PitchClass2PitchClass stack
both are full-height convs over the 12 pitch classes wrapped circularly
(12 x 1, then 12 x k zero-padded by k // 2 on time), with biases. The
widths follow the dense schedule (`models.py:267-308`, heads
`:680-710`; `layer_channels`). Everything else (pools, the pitch-class
stream tiled onto the pitch rows, heads, the temporal mean over the
true length) is `model.Net`'s, and so are the modes.

The state dict's layout is the reference's `best_model.pt` one: each
stack's block at `layer.0`, its layers `denselayer1` .. `denselayerN`,
each `norm1`, `conv1`, `norm2`, `conv2`, an equivariant conv nesting its
weights as `.conv2d`.

Precision: IEEE float32 throughout, except the CQT's bf16 streams, which
`cqt.py` computes; no stack runs in a lower precision (the configuration
states `p2p_stacks` float32, and this module refuses any other). TF32 is
not turned on or off here: a run sets IEEE float32 for its process
(`precision.ieee`), and the check's control turns TF32 on around this
model on purpose.

Departures from the reference repo:
  * it runs its stacks in float64 (`.double()`, models.py:199, 237);
    every configuration here states float32, as the system serves it;
  * dropout inside the dense layers (`drop_rate`, models.py:516-517) is
    left out: the published configuration trains with drop 0, and eval
    and calibration never drop;
  * the weights' draw from the seed and the BatchNorm statistics set by
    `forward(mode="calibrate")` are the benchmark's own, as in
    `model.py`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import model
from .model import PITCH_CLASSES, leaky

__all__ = ["spec", "init_weights", "forward", "layer_channels"]

CONV_LAYERS = 3        # the published conv_layers


def layer_channels(layer: int, n_filters: int,
                   conv_layers: int = CONV_LAYERS) -> tuple:
    """(prev_p, prev_pc, out_p, out_pc) of trunk layer `layer` >= 1 in
    the dense schedule: each stack adds conv_layers * n_filters channels
    to its input, and each stream's input holds the other stream's."""
    grow = n_filters * conv_layers
    prev_p, prev_pc = 1, 1 + grow
    for _ in range(layer - 1):
        prev_p += grow + prev_pc
        prev_pc += grow + prev_p
    out_p = prev_p + prev_pc + grow
    return prev_p, prev_pc, out_p, prev_pc + out_p + grow


def bottleneck(cin: int, n_filters: int) -> int:
    """conv_1's outputs in a block whose input has cin channels."""
    return max(cin // 2, 1) * n_filters


def _check(cfg: dict) -> None:
    if not cfg.get("denseblock"):
        raise ValueError("the dense reference runs denseblock models")
    for flag in ("resblock", "stay_sixth", "p2pc_conv", "pc2p_mem",
                 "max_pool", "linear_reg_multi", "genre", "local"):
        if cfg.get(flag):
            raise ValueError(f"the dense reference has no {flag}")


def tower_spec(cfg: dict, only_semitones: bool) -> list:
    """[(key, shape, kind, fan_in)] of one tower, in state-dict order;
    kind is conv_w, conv_b, bn_w, bn_b, bn_mean or bn_var."""
    _check(cfg)
    k, nf, n = cfg["kernel_size"], cfg["n_filters"], cfg["conv_layers"]
    out = []

    def conv(key, shape, fan_in, bias=True):
        out.append((f"{key}.weight", shape, "conv_w", fan_in))
        if bias:
            out.append((f"{key}.bias", (shape[1] if "up_sixth" in key
                                        else shape[0],), "conv_b", fan_in))

    def bn(key, ch):
        for leaf, kind in (("weight", "bn_w"), ("bias", "bn_b"),
                           ("running_mean", "bn_mean"),
                           ("running_var", "bn_var")):
            out.append((f"{key}.{leaf}", (ch,), kind, 0))

    def stack(key, cin, equivariant):
        mid = bottleneck(cin, nf)
        for i in range(n):
            d, c = f"{key}.layer.0.denselayer{i + 1}", cin + i * nf
            bn(f"{d}.norm1", c)
            if equivariant:
                conv(f"{d}.conv1.conv2d", (mid, c, PITCH_CLASSES, 1),
                     PITCH_CLASSES * c)
            else:
                conv(f"{d}.conv1", (mid, c, 1, 1), c, bias=False)
            bn(f"{d}.norm2", mid)
            if equivariant:
                conv(f"{d}.conv2.conv2d", (nf, mid, PITCH_CLASSES, k),
                     PITCH_CLASSES * k * mid)
            else:
                conv(f"{d}.conv2", (nf, mid, k, k), k * k * mid, bias=False)
        return cin + n * nf

    third = not only_semitones
    pc_ch = 0
    for layer in range(cfg["num_layers"]):
        pre = f"model.{layer}"
        if layer == 0:
            if third:
                conv(f"{pre}.pool_semi", (1, 1, 3, 3), 9)
                bn(f"{pre}.pool_semi_b", 1)
            pc_ch = stack(f"{pre}.pc2pc", 1, True)
            continue
        prev_p, prev_pc, _, _ = layer_channels(layer, nf, n)
        if third:
            conv(f"{pre}.up_sixth", (prev_pc, prev_pc, 3, 1), 3 * prev_pc)
            bn(f"{pre}.up_sixth_b", prev_pc)
        p_ch = stack(f"{pre}.p2p", prev_pc + prev_p, False)
        if third:
            conv(f"{pre}.pool_semi", (p_ch, p_ch, 3, 3), 9 * p_ch)
            bn(f"{pre}.pool_semi_b", p_ch)
        pc_ch = stack(f"{pre}.pc2pc", p_ch + prev_pc, True)
    for head in ("tonic_classifier", "key_classifier"):
        c = pc_ch
        for i in range(cfg["head_layers"]):
            last = i == cfg["head_layers"] - 1
            o = 1 if last else (2 * c if i == 0 else c)
            conv(f"{head}.{3 * i}.conv2d", (o, c, PITCH_CLASSES, k),
                 PITCH_CLASSES * k * c)
            if not last:
                bn(f"{head}.{3 * i + 1}", o)
                c = o
    return out


def spec(cfg: dict) -> list:
    """The whole model's layout: one tower, or `model1.` (36 bins/octave)
    and `model2.` (only_semitones) for the multi-scale ensemble."""
    if not cfg.get("multi_scale"):
        return tower_spec(cfg, cfg.get("only_semitones", False))
    return ([(f"model1.{k}", *r) for k, *r in tower_spec(cfg, False)]
            + [(f"model2.{k}", *r) for k, *r in tower_spec(cfg, True)])


def init_weights(cfg: dict, seed: int, device) -> dict:
    """Weights drawn from `seed` on `device` as `model.init_weights` draws
    them, over this layout."""
    layout = spec(cfg)
    sizes = [int(torch.Size(s).numel()) for _, s, _, _ in layout]
    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(sum(sizes), generator=g, device=device) * 2.0 - 1.0
    n = torch.randn(sum(sizes), generator=g, device=device)
    sd, at = {}, 0
    for (key, shape, kind, fan_in), size in zip(layout, sizes):
        u_, n_ = u[at:at + size].view(shape), n[at:at + size].view(shape)
        at += size
        if kind in ("conv_w", "conv_b"):
            sd[key] = u_ * fan_in ** -0.5
        elif kind == "bn_w":
            sd[key] = 1.0 + 0.2 * n_
        elif kind == "bn_b":
            sd[key] = 0.1 * n_
        elif kind == "bn_mean":
            sd[key] = torch.zeros(shape, device=device)
        else:
            sd[key] = torch.ones(shape, device=device)
    return sd


class Net(model.Net):
    """One tower whose stacks are dense blocks."""

    def __init__(self, sd, cfg, prefix, only_semitones, mode="eval"):
        _check(cfg)
        if cfg.get("stack_dtype", "float32") != "float32":
            raise ValueError("the dense reference runs its stacks in "
                             f"float32, not {cfg['stack_dtype']}")
        super().__init__(sd, cfg, prefix, only_semitones, mode)

    def conv(self, x, key: str, equivariant: bool):
        """A dense layer's conv: wrapped over the pitch classes and
        zero-padded on time, or zero-padded on both axes without bias."""
        if equivariant:
            return self.eq_conv(x, key + ".conv2d", True)
        w = self.w(key + ".weight")
        return F.conv2d(x, w, padding=(w.shape[2] // 2, w.shape[3] // 2))

    def stack(self, x, key, equivariant: bool):
        features = [x]
        for i in range(self.cfg["conv_layers"]):
            d = f"{key}.layer.0.denselayer{i + 1}"
            h = torch.cat(features, dim=1)
            y = self.conv(leaky(self.bn(h, d + ".norm1")), d + ".conv1",
                          equivariant)
            y = self.conv(F.relu(self.bn(y, d + ".norm2")), d + ".conv2",
                          equivariant)
            features.append(y)
        return torch.cat(features, dim=1)


def forward(sd: dict, cfg: dict, mels, seq, *, mode: str = "eval"):
    """(key sigmoid, tonic logits), as `model.forward` gives them, with
    dense stacks."""
    if not cfg.get("multi_scale"):
        return Net(sd, cfg, "", cfg.get("only_semitones", False),
                   mode)(mels[0], seq)
    a = Net(sd, cfg, "model1.", False, mode)(mels[0], seq)
    b = Net(sd, cfg, "model2.", True, mode)(mels[1], seq)
    return tuple((x + y) / 2 for x, y in zip(a, b))
