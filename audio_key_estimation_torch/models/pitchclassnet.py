"""PitchClassNet — transposition-equivariant key/tonic/genre network.

PyTorch port of the JAX package's models/pitchclassnet.py: plain,
residual or dense conv stacks; octave folding by max-pool or by the
learned `p2pc_conv` pool; the third-of-semitone stream with `pool_semi`
and `up_sixth`, or the semitone stream (`stay_sixth`, `only_semitones`);
the pitch-class stream merged back by tile and concat or by the
`pc2p_mem` memory add; key/tonic(/genre) heads; a masked temporal mean or
max (global mode) or per-window outputs (local mode). The public forward
keeps the JAX package's input and outputs; inside, the network runs NCHW
with torch's OIHW weights.

`multi_scale` is the two-tower ensemble (models/multi_scale.py,
`PitchClassNetMulti`; `build_model` picks the class): PitchClassNet
refuses it rather than silently building one tower.

Training: `cfg.remat` recomputes each trunk layer in the backward pass
(torch.utils.checkpoint, the counterpart of the JAX package's nn.remat);
dropout masks come from the generator `set_dropout_generator` gives.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import Config
from ..ops import equivariant as eqv
from ..ops import pooling
from ..ops.frontend import torch_dtype
from ..ops.masked_pool import actual_output_length, masked_time_reduce
from ..utils.profiling import span
from .blocks import (LEAKY_SLOPE, BatchNorm, CircularConv, ConvStack,
                     DenseLayer, EquivariantConv, OctaveConvPool,
                     ThirdUpsample, ZeroPadConv, leaky_relu)
from .schedule import head_in_channels, layer_channels

def _remat_contexts(layer: nn.Module, generator):
    """torch.utils.checkpoint's (forward, recomputation) contexts for one
    trunk layer: the recomputation in the backward pass draws the
    forward's dropout masks again (the generator's state at the forward
    is restored for it, and put back after) and leaves the BatchNorm
    running statistics alone (the forward has updated them)."""
    saved = {}

    @contextlib.contextmanager
    def forward():
        if generator is not None:
            saved["rng"] = generator.get_state()
        yield

    @contextlib.contextmanager
    def recompute():
        bns = [m for m in layer.modules() if isinstance(m, BatchNorm)]
        for m in bns:
            m.update_stats = False
        state = None
        if generator is not None:
            state = generator.get_state()
            generator.set_state(saved["rng"])
        try:
            yield
        finally:
            for m in bns:
                m.update_stats = True
            if state is not None:
                generator.set_state(state)

    return forward(), recompute()


class PitchClassNetLayer(nn.Module):
    """One dual-stream (pitch, pitch-class) stage (models.py:246-399)."""

    def __init__(self, cfg: Config, layer_num: int, generator):
        super().__init__()
        c = cfg
        k = c.kernel_size
        self.cfg, self.layer_num = cfg, layer_num
        # semitone rows; the pitch stream's rows entering layers >= 1
        self.semitone_rows = c.pitches if c.only_semitones else c.pitches // 3
        self.p_rows = self.semitone_rows if c.stay_sixth else c.pitches
        self.third_res = not (c.stay_sixth or c.only_semitones)

        def stack(cin, cout, equivariant):
            return ConvStack(cin, cout, k, c.conv_layers, equivariant,
                             generator, fused_serving=c.fused_convstack,
                             resblock=c.resblock, denseblock=c.denseblock,
                             drop_rate=c.drop)

        def semitone_pool(ch):
            self.pool_semi = CircularConv(ch, ch, (3, 3), generator,
                                          stride=(3, 1), circular_pad=(0, 1))
            self.pool_semi_b = BatchNorm(ch)

        if layer_num == 0:
            if not c.only_semitones:
                semitone_pool(1)
            if c.p2pc_conv:
                self.pool = OctaveConvPool(1, self.semitone_rows, generator)
            self.pc2pc = stack(1, c.n_filters, True)
            return
        ch = layer_channels(layer_num, c.n_filters, c.conv_layers,
                            c.denseblock)
        if self.third_res:
            self.up_sixth = ThirdUpsample(ch.prev_pc, ch.prev_pc, generator)
            self.up_sixth_b = BatchNorm(ch.prev_pc)
        self.p2p = stack(ch.prev_p if c.pc2p_mem else ch.prev_pc + ch.prev_p,
                         ch.growth if c.denseblock else ch.out_p, False)
        p_ch = self.p2p.out_channels
        if self.third_res:
            semitone_pool(p_ch)
        if c.p2pc_conv:
            self.pool = OctaveConvPool(p_ch, self.semitone_rows, generator)
        self.pc2pc = stack(p_ch + ch.prev_pc,
                           ch.growth if c.denseblock else ch.out_pc, True)

    def _octave_pool(self, x):
        if self.cfg.p2pc_conv:
            return self.pool(x)
        return pooling.octave_max_pool(x)

    def _semitone_pool(self, x):
        return leaky_relu(self.pool_semi_b(self.pool_semi(x)))

    def forward(self, p, pc, local: bool = False):
        c = self.cfg
        if self.layer_num == 0:
            p_semi = p if c.only_semitones else self._semitone_pool(p)
            if c.stay_sixth:
                p = p_semi
            return p, self.pc2pc(self._octave_pool(p_semi))
        if self.third_res:
            p_sixth = leaky_relu(self.up_sixth_b(self.up_sixth(pc)))
            if c.pc2p_mem:
                p = eqv.pc_to_pitch_memory_add(p, p_sixth)
            else:
                p = torch.cat([p, eqv.pc_to_pitch_tile(p_sixth, self.p_rows)],
                              dim=1)
        elif not c.pc2p_mem:
            p = torch.cat([p, eqv.pc_to_pitch_tile(pc, self.p_rows)], dim=1)
        # else the reference quirk (models.py:380-383, kept by the JAX
        # package for checkpoint parity): with stay_sixth/only_semitones
        # and pc2p_mem the pitch-class stream is never merged back
        p = self.p2p(p)
        pc2 = self._semitone_pool(p) if self.third_res else p
        pc = self.pc2pc(torch.cat([pc, self._octave_pool(pc2)], dim=1))
        if not local:
            pool = c.time_pool_size
            p = pooling.time_max_pool(p, pool)
            pc = pooling.time_max_pool(pc, pool)
        return p, pc


class Head(nn.Sequential):
    """Classifier head (models.py:713-742). kind: 'key' | 'tonic' | 'genre'.

    In local mode the key and tonic heads end in a sliding max over each
    window of frames * loc_window_size input frames (models.py:721-722);
    the genre head has none."""

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
        self.window = (None if kind == "genre" else
                       cfg.frames * cfg.loc_window_size
                       - cfg.head_layers * (k - 1))

    def forward(self, x, local: bool = False):
        x = super().forward(x)
        if local and self.window is not None:
            x = pooling.sliding_time_max(x, self.window)
        return x


class PitchClassNet(nn.Module):
    """Trunk layers + key/tonic(/genre) heads (models.py:651-817).

    forward(mel, seq_length) with
      mel        : (N, pitches, T, 1) log-CQT (the JAX package's layout)
      seq_length : (N,) true frame counts, or None (unused in local mode)
    returns global mode (key (N, 12) sigmoid, tonic (N, 12) logits[,
    genre (N, 11)]), or with `cfg.local` time-major per-window outputs
    (key (N, T', 12) sigmoid, tonic (N, T', 12)[, genre (N, T_g, 11)]).
    Local mode adds no parameters, so a global and a local model load one
    state_dict. Parameters are float32; `cfg.dtype` selects the compute
    dtype.
    """

    def __init__(self, cfg: Config, generator: torch.Generator | None = None):
        super().__init__()
        if cfg.multi_scale:
            raise ValueError("Config.multi_scale=True is the two-tower "
                             "ensemble: build PitchClassNetMulti "
                             "(models.build_model picks the class)")
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        self.cfg = cfg
        self.model = nn.ModuleList(
            [PitchClassNetLayer(cfg, i, generator)
             for i in range(cfg.num_layers)])
        final_ch = head_in_channels(cfg.num_layers, cfg.n_filters,
                                    cfg.conv_layers, cfg.denseblock)
        self.tonic_classifier = Head(cfg, final_ch, "tonic", generator)
        self.key_classifier = Head(cfg, final_ch, "key", generator)
        self.genre_classifier = (Head(cfg, final_ch, "genre", generator)
                                 if cfg.genre else None)
        self.dropout_generator = None

    def set_dropout_generator(self, generator: torch.Generator) -> None:
        """Draw every dropout mask (the dense blocks' layers, training
        mode) from `generator`, a torch.Generator on the model's device."""
        self.dropout_generator = generator
        for m in self.modules():
            if isinstance(m, DenseLayer):
                m.generator = generator

    def forward(self, mel, seq_length=None):
        with span("akx.model"):
            return self._forward(mel, seq_length)

    def _forward(self, mel, seq_length):
        c = self.cfg
        local = c.local
        p = mel.to(torch_dtype(c.dtype)).permute(0, 3, 1, 2)
        pc = None
        remat = c.remat and self.training and torch.is_grad_enabled()
        for layer in self.model:
            if remat:
                p, pc = checkpoint(layer, p, pc, local, use_reentrant=False,
                                   context_fn=functools.partial(
                                       _remat_contexts, layer,
                                       self.dropout_generator))
            else:
                p, pc = layer(p, pc, local)
        heads = [self.key_classifier, self.tonic_classifier]
        if self.genre_classifier is not None:
            heads.append(self.genre_classifier)
        outs = [head(pc, local).float()[:, 0] for head in heads]
        if local:
            # time-major per-window outputs (models.py:806-810, intended
            # semantics as in the JAX package)
            outs = [o.transpose(1, 2) for o in outs]
        else:
            lengths = None
            if seq_length is not None:
                lengths = torch.clamp(actual_output_length(
                    seq_length, num_layers=c.num_layers,
                    time_pool_size=c.time_pool_size,
                    kernel_size=c.kernel_size,
                    head_layers=c.head_layers), min=1)
            outs = [masked_time_reduce(o, lengths, use_max=c.max_pool)
                    for o in outs]
        outs[0] = torch.sigmoid(outs[0])
        return tuple(outs)
