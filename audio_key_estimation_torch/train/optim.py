"""Optimizer: Adam + per-epoch exponential LR decay (models.py:1017-1027),
the port of the JAX package's train/optim.py.

torch.optim.Adam(weight_decay=reg) applies L2 *into the gradient* before
the moment updates (not decoupled AdamW), as the JAX package's
add_decayed_weights ahead of adam does. The rate is a staircase on the
optimizer's step count, lr * gamma ** (step // steps_per_epoch), set
before every update (`set_learning_rate`), so it follows optax's
exponential_decay(staircase=True) and a resumed run keeps its stair.
"""

from __future__ import annotations

from typing import Iterable

import torch

from ..config import Config


def make_optimizer(cfg: Config, params: Iterable) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.reg)


def learning_rate(cfg: Config, step: int, steps_per_epoch: int) -> float:
    """The rate of update number `step` (0-based)."""
    return cfg.lr * cfg.gamma ** (step // max(steps_per_epoch, 1))


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
