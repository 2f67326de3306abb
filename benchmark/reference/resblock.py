"""PitchClassNet with residual stacks (`train_model.py --resblock`) as
plain PyTorch functions.

flo-stilz/Audio-Key-Estimation, `models.py:168-243` (PitchClass2PitchClass,
Pitch2Pitch) with `ResBlock` (`:402-427`) and `ResBlockEquivariant`
(`:429-454`): every ConvStack is a stem and `conv_layers` residual blocks,

    h = leaky(BN(conv_{cin->f}(x)))
    r = leaky(BN1(conv_{f->2f}(h)));  h = leaky(h + BN2(conv_{2f->f}(r)))

with 7x7 circular convs over the pitch rows (Pitch2Pitch) or 12 x 7
full-height convs over the pitch classes wrapped circularly, zero-padded
on time (PitchClass2PitchClass). Everything else (pools, the pitch-class
stream tiled onto the pitch rows, heads, the temporal mean over the true
length) is `model.Net`'s, and so are the modes and the weights' draw.

The state dict's layout is the reference's `best_model.pt` one: each
stack's stem at `layer.0` (conv) and `layer.1` (BatchNorm), then its
blocks from `layer.3`, each `conv1`, `conv2`, `b1`, `b2`, an equivariant
conv nesting its weights as `.conv2d`.

Precision: IEEE float32 throughout, except the CQT's bf16 streams, which
`cqt.py` computes; no stack runs in a lower precision (the configuration
states `p2p_stacks` float32, and this module refuses any other).

No departure from those equations is known. What is the benchmark's own,
as in `model.py`: the weights' draw from the seed and the BatchNorm
statistics set by `forward(mode="calibrate")`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import model
from .model import PITCH_CLASSES, circular_pad, layer_channels, leaky

__all__ = ["spec", "init_weights", "forward", "layer_channels"]


def _blocks(stack: str, f: int, equivariant: bool, cfg: dict) -> list:
    """[(key, shape, kind, fan_in)] of one stack's residual blocks."""
    k = cfg["kernel_size"]
    out = []

    def conv(key, cout, cin):
        if equivariant:
            shape, fan_in = (cout, cin, PITCH_CLASSES, k), PITCH_CLASSES * k * cin
            key += ".conv2d"
        else:
            shape, fan_in = (cout, cin, k, k), k * k * cin
        out.append((f"{key}.weight", shape, "conv_w", fan_in))
        out.append((f"{key}.bias", (cout,), "conv_b", fan_in))

    def bn(key, ch):
        for leaf, kind in (("weight", "bn_w"), ("bias", "bn_b"),
                           ("running_mean", "bn_mean"),
                           ("running_var", "bn_var")):
            out.append((f"{key}.{leaf}", (ch,), kind, 0))

    for j in range(cfg["conv_layers"]):
        pre = f"{stack}.layer.{3 + j}"
        conv(f"{pre}.conv1", 2 * f, f)
        conv(f"{pre}.conv2", f, 2 * f)
        bn(f"{pre}.b1", 2 * f)
        bn(f"{pre}.b2", f)
    return out


def tower_spec(cfg: dict, only_semitones: bool) -> list:
    """One tower's layout: `model.tower_spec` with one conv a stack (the
    stem), each stack's blocks after its stem's BatchNorm."""
    stems = model.tower_spec(dict(cfg, resblock=False, conv_layers=1),
                             only_semitones)
    out = []
    for key, shape, kind, fan_in in stems:
        out.append((key, shape, kind, fan_in))
        stack, sep, leaf = key.partition(".layer.1.")
        if sep and leaf == "running_var":
            out += _blocks(stack, shape[0], stack.endswith(".pc2pc"), cfg)
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
    """One tower whose stacks are residual."""

    def __init__(self, sd, cfg, prefix, only_semitones, mode="eval"):
        if cfg.get("stack_dtype", "float32") != "float32":
            raise ValueError("the residual reference runs its stacks in "
                             f"float32, not {cfg['stack_dtype']}")
        super().__init__(sd, cfg, prefix, only_semitones, mode)

    def conv(self, x, key: str, equivariant: bool):
        if equivariant:
            return self.eq_conv(x, key + ".conv2d", True)
        w = self.w(key + ".weight")
        return F.conv2d(circular_pad(x, w.shape[2] // 2, w.shape[3] // 2),
                        w, self.w(key + ".bias"))

    def stack(self, x, key, equivariant: bool):
        h = leaky(self.bn(self.conv(x, f"{key}.layer.0", equivariant),
                          f"{key}.layer.1"))
        for j in range(self.cfg["conv_layers"]):
            b = f"{key}.layer.{3 + j}"
            r = leaky(self.bn(self.conv(h, b + ".conv1", equivariant),
                              b + ".b1"))
            h = leaky(h + self.bn(self.conv(r, b + ".conv2", equivariant),
                                  b + ".b2"))
        return h


def forward(sd: dict, cfg: dict, mels, seq, *, mode: str = "eval"):
    """(key sigmoid, tonic logits), as `model.forward` gives them, with
    residual stacks."""
    if not cfg.get("multi_scale"):
        return Net(sd, cfg, "", cfg.get("only_semitones", False),
                   mode)(mels[0], seq)
    a = Net(sd, cfg, "model1.", False, mode)(mels[0], seq)
    b = Net(sd, cfg, "model2.", True, mode)(mels[1], seq)
    return tuple((x + y) / 2 for x, y in zip(a, b))
