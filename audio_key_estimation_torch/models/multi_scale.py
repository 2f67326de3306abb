"""Two-scale PitchClassNet ensemble (reference PitchClassNet_Multi,
models.py:1118-1189), the PyTorch port of the JAX package's
models/multi_scale.py.

model1 consumes the 36-bins/octave CQT, model2 the 12-bins/octave CQT
(`mel2`); outputs merge by averaging or a learned per-class linear
regression (--linear_reg_multi, models.py:1148-1182).

Intended-behavior divergences from the reference (latent bugs there),
kept as the JAX package has them:
 * model2 is built as a true semitone model (only_semitones=True with
   pitches = octaves*12); the reference constructs it with third-of-semitone
   geometry and a dead `no_semitones` attribute (models.py:1143-1146), which
   cannot run on 12-bin input.
 * genre regression weights are 11-dim (the genre head emits 11 logits); the
   reference allocates 12 (models.py:1154-1155) which cannot broadcast.
 * the reference's local-mode loss references an undefined `mel`
   (models.py:1230); our harness uses the batch's features.

`build_model` picks PitchClassNet or the ensemble from a Config; every
place that builds a model from a Config goes through it.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import Config
from ..ops.frontend import torch_dtype
from ..utils.profiling import span
from .pitchclassnet import PitchClassNet


class PitchClassNetMulti(nn.Module):
    """model1 (cfg) and model2 (cfg with only_semitones) merged.

    forward(mel1, mel2, seq_length) with
      mel1 : (N, octaves * 36, T, 1) log-CQT at cfg.bins_per_octave
      mel2 : (N, octaves * 12, T, 1) log-CQT at 12 bins/octave
    returns what PitchClassNet returns (global or, with `cfg.local`,
    per-window outputs). Averaging merges key, tonic (and genre) by the
    mean; with `cfg.linear_reg_multi` per class
      key   = sigmoid(wk[0] * key1 + wk[1] * key2 + bk)   (keys already
              sigmoids, as in the JAX package)
      tonic = wt[0] * tonic1 + wt[1] * tonic2 + bt
      genre = wg[0] * genre1 + wg[1] * genre2 + bg
    with wk, wt (2, 12), bk, bt (12,), wg (2, 11), bg (11,) in the
    model's dtype, drawn N(0, 1) from `generator` after both towers.
    """

    def __init__(self, cfg: Config, generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        self.cfg = cfg
        self.model1 = PitchClassNet(cfg.replace(multi_scale=False), generator)
        self.model2 = PitchClassNet(
            cfg.replace(only_semitones=True, multi_scale=False), generator)
        if cfg.linear_reg_multi:
            dtype = torch_dtype(cfg.dtype)

            def param(*shape):
                return nn.Parameter(torch.randn(shape, generator=generator)
                                    .to(dtype))
            self.wk, self.bk = param(2, 12), param(12)
            self.wt, self.bt = param(2, 12), param(12)
            if cfg.genre:
                self.wg, self.bg = param(2, 11), param(11)

    @property
    def dropout_generator(self):
        return self.model1.dropout_generator

    def set_dropout_generator(self, generator: torch.Generator) -> None:
        """Draw both towers' dropout masks from `generator`."""
        self.model1.set_dropout_generator(generator)
        self.model2.set_dropout_generator(generator)

    def forward(self, mel1, mel2, seq_length=None):
        # one akx.model span: the towers' own open none inside it
        with span("akx.model"):
            return self._forward(mel1, mel2, seq_length)

    def _forward(self, mel1, mel2, seq_length):
        out1 = self.model1(mel1, seq_length)
        out2 = self.model2(mel2, seq_length)
        if not self.cfg.linear_reg_multi:
            return tuple((a + b) / 2 for a, b in zip(out1, out2))
        key = torch.sigmoid(self.wk[0] * out1[0] + self.wk[1] * out2[0]
                            + self.bk)
        tonic = self.wt[0] * out1[1] + self.wt[1] * out2[1] + self.bt
        if not self.cfg.genre:
            return key, tonic
        return key, tonic, self.wg[0] * out1[2] + self.wg[1] * out2[2] \
            + self.bg


def build_model(cfg: Config, generator: torch.Generator | None = None
                ) -> nn.Module:
    """The model a Config describes: PitchClassNetMulti when
    cfg.multi_scale, else PitchClassNet."""
    cls = PitchClassNetMulti if cfg.multi_scale else PitchClassNet
    return cls(cfg, generator)
