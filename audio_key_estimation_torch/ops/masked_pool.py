"""Masked temporal reduction over true sequence lengths (vectorized
replacement of the reference's per-sample loop, models.py:754-785;
counterpart of the JAX package's ops/masked_pool.py)."""

from __future__ import annotations

import torch


def actual_output_length(seq_length: torch.Tensor, *, num_layers: int,
                         time_pool_size: int, kernel_size: int,
                         head_layers: int) -> torch.Tensor:
    """Model-output frames for a given input length (models.py:757-760):
    floor-divide by time_pool_size once per layer >= 1, then subtract the
    heads' receptive-field shrinkage (kernel_size-1 per head layer)."""
    length = seq_length.to(torch.float32)
    for _ in range(num_layers - 1):
        length = torch.floor(length / time_pool_size)
    return length.to(torch.int32) - (kernel_size - 1) * head_layers


def masked_time_reduce(x: torch.Tensor, lengths: torch.Tensor | None, *,
                       use_max: bool = False) -> torch.Tensor:
    """Reduce (N, R, T) -> (N, R) over the first `lengths[n]` frames
    (the whole axis when lengths is None): mean, or max with use_max."""
    if lengths is None:
        return x.amax(dim=-1) if use_max else x.mean(dim=-1)
    t = x.shape[-1]
    mask = (torch.arange(t, device=x.device)[None, None, :]
            < lengths.to(x.device)[:, None, None])
    if use_max:
        return torch.where(mask, x, float("-inf")).amax(dim=-1)
    denom = torch.clamp(lengths, min=1).to(device=x.device, dtype=x.dtype)
    return torch.where(mask, x, 0).sum(dim=-1) / denom[:, None]
