"""The fused serving ConvStack on the card: kernel C and its stack.

An eval-mode Pitch2Pitch ConvStack (7x7 circular conv -> BatchNorm ->
leaky-ReLU, x conv_layers, <= 8 channels, 8 outputs) runs as one kernel
launch per layer, csrc/conv7.cu (replaces the JAX package's
`ops/convstack_pallas.py::_conv7_layer`), with BatchNorm folded into the
weights in float32 outside the kernel, then cast to bf16 as the JAX
package does (`convstack_pallas.py:303-307`). Activations between layers stay bf16,
channels-last (B, H, T, 8); accumulation is float32.

`conv7_layer` launches the kernel for a CUDA tensor (or raises) and runs
its plain PyTorch version only for a CPU tensor; `conv7_layer.launches`
counts kernel launches. `conv7_layer_plain` in float32 is the exact
folded stack (tests pin it to the flax ConvStack); in bf16 it reproduces
the kernel's numerics (bf16 operands, f32 sums, bf16 output).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .equivariant import circular_pad

LEAKY_SLOPE = 0.01
C = 8          # supported output channels; inputs pad up to this width
KERNEL = 7


def fold_bn_affine(gamma, beta, mean, var, eps: float = 1e-5):
    """Eval BatchNorm as per-channel (scale, shift), in float32."""
    s = gamma.float() / torch.sqrt(var.float() + eps)
    return s, beta.float() - mean.float() * s


def fold_layer(weight, bias, gamma, beta, mean, var, eps: float = 1e-5):
    """Conv (OIHW) + eval BatchNorm -> folded (weight, bias) in float32."""
    s, t = fold_bn_affine(gamma, beta, mean, var, eps)
    return weight.float() * s[:, None, None, None], bias.float() * s + t


def supported_geometry(H: int, T: int, cins) -> bool:
    """Kernel C's contract: <= 8 input channels in every layer and both
    spatial axes at least as long as the circular pad (3); any B and H.
    At T < 3 (or H < 3) the JAX package's concat wrap pads by fewer rows
    than the kernel, so the plain path must run there."""
    return H >= 3 and T >= 3 and all(1 <= ci <= C for ci in cins)


def to_channels_last(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, Cin, H, T) -> (B, H, T, 8) contiguous, channels zero-padded."""
    x = x.permute(0, 2, 3, 1).to(dtype)
    return F.pad(x, (0, C - x.shape[-1])).contiguous()


def pack_weight(weight: torch.Tensor) -> torch.Tensor:
    """(8, ci, 7, 7) folded bf16 weight -> (50, 8, 8) [tap][co][ci] with
    tap = dh*7 + dt; tap 49 and ci >= ci_true are zero."""
    co, ci = weight.shape[:2]
    w = weight.permute(2, 3, 0, 1).reshape(KERNEL * KERNEL, co, ci)
    return F.pad(w, (0, C - ci, 0, 0, 0, 1)).contiguous()


def conv7_layer_plain(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel C: x (B, H, T, 8) channels-last, weight
    (8, ci, 7, 7) folded, bias (8,) float32 -> (B, H, T, 8) in x's dtype,
    computed in float32 from x's and weight's values."""
    ci = weight.shape[1]
    xf = x[..., :ci].permute(0, 3, 1, 2).float()
    y = F.conv2d(circular_pad(xf, 3, 3), weight.float()) \
        + bias.float()[None, :, None, None]
    y = torch.where(y >= 0, y, LEAKY_SLOPE * y)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def conv7_layer(x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """One folded conv + leaky layer (kernel C on CUDA, plain on CPU).

    x (B, H, T, 8) bf16 channels-last; weight (8, ci, 7, 7) bf16 folded;
    bias (8,) float32.
    """
    if x.is_cpu:
        return conv7_layer_plain(x, weight, bias)
    if not x.is_cuda:
        raise ValueError(f"conv7_layer: unsupported device {x.device}")
    _, H, T, c = x.shape
    if (x.dtype != torch.bfloat16 or weight.dtype != torch.bfloat16
            or c != C or not x.is_contiguous() or x.data_ptr() % 16
            or tuple(weight.shape[:1]) + tuple(weight.shape[2:]) != (C, 7, 7)
            or bias.shape != (C,)
            or not supported_geometry(H, T, [weight.shape[1]])):
        raise ValueError(f"conv7_layer: unsupported x {x.dtype} "
                         f"{tuple(x.shape)}, weight {weight.dtype} "
                         f"{tuple(weight.shape)}, bias {tuple(bias.shape)}")
    wp = pack_weight(weight)
    bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    y = _build.op("conv7")(x, wp, bias)
    conv7_layer.launches += 1
    return y


conv7_layer.launches = 0


def fused_convstack(x: torch.Tensor, layers) -> torch.Tensor:
    """Serving-path ConvStack: x (B, Cin, H, T) -> (B, 8, H, T) in x's
    dtype, through bf16 activations. layers: [(weight (8, ci, 7, 7),
    bias (8,)), ...] folded in float32."""
    h = to_channels_last(x, torch.bfloat16)
    for w, b in layers:
        h = conv7_layer(h, w.to(torch.bfloat16), b)
    return h.permute(0, 3, 1, 2).to(x.dtype)
