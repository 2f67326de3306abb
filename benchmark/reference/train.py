"""A training step in plain PyTorch: the reference's loss, gradient
accumulation and Adam.

A step of `acc_grad` micro-batches (train_model.py:83-84,110-122): each
micro-batch runs the model in training mode (BatchNorm on the
micro-batch's statistics, float32 throughout) and its loss, the mean
over its clips of the key term (binary cross entropy of the 12 key
sigmoids against the key's pitch classes, predictions clamped to
[1e-7, 1 - 1e-7]) plus the tonic term (softmax cross entropy against the
tonic), is backpropagated; the summed gradients are divided by
`acc_grad`, then Adam (betas 0.9, 0.999, eps 1e-8, no weight decay)
updates every parameter: m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
p -= lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps).
"""

from __future__ import annotations

import math

import torch

from . import of

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
CLAMP = 1e-7


def is_parameter(key: str) -> bool:
    """Running statistics are buffers; everything else trains."""
    return not key.endswith(("running_mean", "running_var"))


def micro_loss(sd: dict, cfg: dict, micro: dict, half: bool = False):
    """The loss of one micro-batch: {"mel", "seq_length", "key_labels",
    "tonic_labels"} tensors, mel (N, rows, T, 1). With `half`, a fault:
    only the first half of its clips, the mean taken over them."""
    n = micro["mel"].shape[0]
    rows = slice(0, max(n // 2, 1)) if half else slice(0, n)
    mel = micro["mel"][rows, ..., 0]
    key, tonic = of(cfg).forward(sd, cfg, [mel], micro["seq_length"][rows],
                                 mode="train")
    y = micro["key_labels"][rows].to(key.dtype)
    p = torch.clamp(key, CLAMP, 1 - CLAMP)
    bce = -(y * torch.log(p) + (1 - y) * torch.log(1 - p)).mean(-1)
    target = torch.argmax(micro["tonic_labels"][rows], dim=1)
    ce = -torch.log_softmax(tonic, dim=-1).gather(1, target[:, None])[:, 0]
    return cfg.get("key_weight", 1.0) * bce.mean() \
        + cfg.get("tonic_weight", 1.0) * ce.mean()


class Adam:
    def __init__(self, params: dict, lr: float):
        self.lr, self.t = lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        b1, b2 = BETAS
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = self.v[k].sqrt() / math.sqrt(c2) + ADAM_EPS
                p.addcdiv_(self.m[k], denom, value=-self.lr / c1)


def step(sd: dict, cfg: dict, batch: dict, adam: Adam, *,
         half: bool = False, frozen: bool = False) -> tuple:
    """One training step on `batch` (tensors stacked (acc_grad, micro,
    ...)): (the micro-batches' mean loss, the averaged gradients). The
    parameters of `sd` are updated in place unless `frozen` (a fault: the
    state returned unchanged)."""
    params = {k: v for k, v in sd.items() if is_parameter(k)}
    for v in params.values():
        v.requires_grad_(True)
        v.grad = None
    acc = batch["mel"].shape[0]
    losses = []
    for i in range(acc):
        loss = micro_loss(sd, cfg, {k: v[i] for k, v in batch.items()}, half)
        loss.backward()
        losses.append(loss.detach())
    grads = {k: v.grad / acc for k, v in params.items()}
    for v in params.values():
        v.requires_grad_(False)
        v.grad = None
    if not frozen:
        adam.step(params, grads)
    return torch.stack(losses).mean(), grads
