"""PitchClassNet channel-width schedule.

The reference computes layer channel widths with branchy inline arithmetic
(models.py:267-308 per layer; models.py:680-710 for the heads). The schedule
must be replicated *exactly* or ported torch checkpoints will not load.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class LayerChannels:
    prev_p: int    # channels of incoming pitch stream
    prev_pc: int   # channels of incoming pitch-class stream
    out_p: int     # channels of pitch stream produced by this layer
    out_pc: int    # channels of pitch-class stream produced by this layer
    growth: int    # denseblock growth rate (n_filters) — 0 if not dense


def layer_channels(layer_num: int, n_filters: int, conv_layers: int,
                   denseblock: bool) -> LayerChannels:
    """Channel widths for PitchClassNetLayer `layer_num` (models.py:267-308)."""
    if denseblock:
        prev_p = 1
        prev_pc = 1 + n_filters * conv_layers
        for _ in range(layer_num - 1):
            prev_p += n_filters * conv_layers + prev_pc
            prev_pc += n_filters * conv_layers + prev_p
        out_p = prev_p + n_filters * conv_layers + prev_pc
        out_pc = prev_pc + n_filters * conv_layers + prev_p
        return LayerChannels(prev_p, prev_pc, out_p, out_pc, n_filters)

    if layer_num == 0:
        prev_p, prev_pc = 0, 0
    elif layer_num == 1:
        prev_p, prev_pc = 1, n_filters
    elif layer_num == 2:
        prev_p = n_filters * 2
        prev_pc = 2 * prev_p
    else:
        prev_p = (n_filters * 2) * (4 ** (layer_num - 2))
        prev_pc = 2 * prev_p

    if layer_num == 0:
        # out_pc=4 reproduces models.py:307 but is dead in both codebases:
        # layer 0's pc-conv stack actually emits n_filters channels
        # (pitchclassnet.py builds it from cfg.n_filters, not this value).
        out_p, out_pc = 1, 4
    elif layer_num == 1:
        out_p = 2 * n_filters
        out_pc = 2 * out_p
    else:
        out_p = 4 * prev_p
        out_pc = 4 * prev_pc
    return LayerChannels(prev_p, prev_pc, out_p, out_pc, 0)


def head_in_channels(num_layers: int, n_filters: int, conv_layers: int,
                     denseblock: bool) -> int:
    """Input channels of the classifier heads (models.py:680-710)."""
    if denseblock:
        prev_p = 1
        prev_pc = 1 + n_filters * conv_layers
        for _ in range(num_layers - 2):
            prev_p += n_filters * conv_layers + prev_pc
            prev_pc += n_filters * conv_layers + prev_p
        if num_layers > 1:
            out_p = prev_p + n_filters * conv_layers + prev_pc
            return prev_pc + n_filters * conv_layers + out_p
        return prev_pc

    if num_layers == 1:
        return n_filters
    if num_layers == 2:
        prev_pc = n_filters
    elif num_layers == 3:
        prev_pc = 2 * (n_filters * 2)
    else:
        prev_pc = 2 * ((n_filters * 2) * (4 ** (num_layers - 3)))
    return 4 * prev_pc
