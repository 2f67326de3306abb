"""What the conv stacks' epilogues share, on the module path and in the
hand kernels: the leaky-ReLU slope and eval BatchNorm as an affine."""

import torch

LEAKY_SLOPE = 0.01


def fold_bn_affine(gamma, beta, mean, var, eps: float = 1e-5):
    """Eval BatchNorm as per-channel (scale, shift), in float32."""
    s = gamma.float() / torch.sqrt(var.float() + eps)
    return s, beta.float() - mean.float() * s
