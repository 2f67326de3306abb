"""PitchClassNet — transposition-equivariant key/tonic/genre network.

PyTorch port of the JAX package's models/pitchclassnet.py, default
variant: plain conv stacks, octave max-pool, `pool_semi` third->semitone
pooling, `up_sixth` upsample and tile, key/tonic(/genre) heads, masked
temporal mean. The public forward keeps the JAX package's input and
outputs; inside, the network runs NCHW with torch's OIHW weights.

The other variants raise NotImplementedError naming their ROADMAP.md port
queue item rather than silently running something else.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import Config
from ..ops import equivariant as eqv
from ..ops import pooling
from ..ops.frontend import torch_dtype
from ..ops.masked_pool import actual_output_length, masked_time_reduce
from .blocks import (LEAKY_SLOPE, BatchNorm, CircularConv, ConvStack,
                     EquivariantConv, ThirdUpsample, ZeroPadConv, leaky_relu)
from .schedule import head_in_channels, layer_channels

# Config fields the port does not serve yet -> their ROADMAP.md item
_LATER = {
    "resblock": "port queue item 1 (remaining model variants)",
    "denseblock": "port queue item 1 (remaining model variants)",
    "p2pc_conv": "port queue item 1 (remaining model variants)",
    "pc2p_mem": "port queue item 1 (remaining model variants)",
    "stay_sixth": "port queue item 1 (remaining model variants)",
    "only_semitones": "port queue item 1 (remaining model variants)",
    "local": "port queue item 2 (local mode)",
    "multi_scale": "port queue item 8 (multi_scale)",
}


def check_supported(cfg: Config) -> None:
    """Raise NotImplementedError for a configuration the port cannot run."""
    for field, item in _LATER.items():
        if getattr(cfg, field):
            raise NotImplementedError(
                f"Config.{field}=True is not ported yet: ROADMAP.md {item}")


class PitchClassNetLayer(nn.Module):
    """One dual-stream (pitch, pitch-class) stage (models.py:246-399)."""

    def __init__(self, cfg: Config, layer_num: int, generator):
        super().__init__()
        c = cfg
        k = c.kernel_size
        self.cfg, self.layer_num = cfg, layer_num
        if layer_num == 0:
            self.pool_semi = CircularConv(1, 1, (3, 3), generator,
                                          stride=(3, 1), circular_pad=(0, 1))
            self.pool_semi_b = BatchNorm(1)
            self.pc2pc = ConvStack(1, c.n_filters, k, c.conv_layers, True,
                                   generator)
            return
        ch = layer_channels(layer_num, c.n_filters, c.conv_layers, False)
        self.up_sixth = ThirdUpsample(ch.prev_pc, ch.prev_pc, generator)
        self.up_sixth_b = BatchNorm(ch.prev_pc)
        self.p2p = ConvStack(ch.prev_pc + ch.prev_p, ch.out_p, k,
                             c.conv_layers, False, generator,
                             fused_serving=c.fused_convstack)
        self.pool_semi = CircularConv(ch.out_p, ch.out_p, (3, 3), generator,
                                      stride=(3, 1), circular_pad=(0, 1))
        self.pool_semi_b = BatchNorm(ch.out_p)
        self.pc2pc = ConvStack(ch.out_p + ch.prev_pc, ch.out_pc, k,
                               c.conv_layers, True, generator)

    def forward(self, p, pc):
        if self.layer_num == 0:
            p_semi = leaky_relu(self.pool_semi_b(self.pool_semi(p)))
            return p, self.pc2pc(pooling.octave_max_pool(p_semi))
        p_sixth = leaky_relu(self.up_sixth_b(self.up_sixth(pc)))
        p = torch.cat([p, eqv.pc_to_pitch_tile(p_sixth, self.cfg.pitches)],
                      dim=1)
        p = self.p2p(p)
        pc2 = leaky_relu(self.pool_semi_b(self.pool_semi(p)))
        pc = self.pc2pc(torch.cat([pc, pooling.octave_max_pool(pc2)], dim=1))
        pool = self.cfg.time_pool_size
        return pooling.time_max_pool(p, pool), pooling.time_max_pool(pc, pool)


class Head(nn.Sequential):
    """Classifier head (models.py:713-742). kind: 'key' | 'tonic' | 'genre'."""

    def __init__(self, cfg: Config, in_ch: int, kind: str, generator):
        k = cfg.kernel_size
        ch = in_ch
        mods = []
        for i in range(cfg.head_layers):
            last = i == cfg.head_layers - 1
            out = 1 if last else (2 * ch if i == 0 else ch)
            if kind == "genre":
                mods.append(ZeroPadConv(ch, out, (2 if last else 1, k),
                                        generator))
            else:
                mods.append(EquivariantConv(ch, out, k, generator))
            if not last:
                mods += [BatchNorm(out), nn.LeakyReLU(LEAKY_SLOPE)]
                ch = out
        super().__init__(*mods)


class PitchClassNet(nn.Module):
    """Trunk layers + key/tonic(/genre) heads (models.py:651-817).

    forward(mel, seq_length) with
      mel        : (N, pitches, T, 1) log-CQT (the JAX package's layout)
      seq_length : (N,) true frame counts, or None
    returns (key (N, 12) sigmoid, tonic (N, 12) logits[, genre (N, 11)]).
    Parameters are float32; `cfg.dtype` selects the compute dtype.
    """

    def __init__(self, cfg: Config, generator: torch.Generator | None = None):
        super().__init__()
        check_supported(cfg)
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        self.cfg = cfg
        self.model = nn.ModuleList(
            [PitchClassNetLayer(cfg, i, generator)
             for i in range(cfg.num_layers)])
        final_ch = head_in_channels(cfg.num_layers, cfg.n_filters,
                                    cfg.conv_layers, False)
        self.tonic_classifier = Head(cfg, final_ch, "tonic", generator)
        self.key_classifier = Head(cfg, final_ch, "key", generator)
        self.genre_classifier = (Head(cfg, final_ch, "genre", generator)
                                 if cfg.genre else None)

    def forward(self, mel, seq_length=None):
        c = self.cfg
        p = mel.to(torch_dtype(c.dtype)).permute(0, 3, 1, 2)
        pc = None
        for layer in self.model:
            p, pc = layer(p, pc)
        lengths = None
        if seq_length is not None:
            lengths = torch.clamp(actual_output_length(
                seq_length, num_layers=c.num_layers,
                time_pool_size=c.time_pool_size, kernel_size=c.kernel_size,
                head_layers=c.head_layers), min=1)

        def reduce(head):
            return masked_time_reduce(head(pc).float()[:, 0], lengths,
                                      use_max=c.max_pool)

        key = torch.sigmoid(reduce(self.key_classifier))
        tonic = reduce(self.tonic_classifier)
        if self.genre_classifier is not None:
            return key, tonic, reduce(self.genre_classifier)
        return key, tonic
