"""The fused serving ConvStack on the card: kernel C and its stack.

An eval-mode Pitch2Pitch ConvStack (7x7 circular conv -> BatchNorm ->
leaky-ReLU, x conv_layers, <= 8 channels, 8 outputs) runs as one kernel
launch per layer, csrc/conv7.cu (replaces the JAX package's
`ops/convstack_pallas.py::_conv7_layer`), with BatchNorm folded into the
weights in float32 outside the kernel, then cast to bf16 as the JAX
package does (`convstack_pallas.py:303-307`) and packed once per stack
call in the kernel's fragment order (`pack_stack`). The first layer reads
the stack's NCHW input in its own dtype and rounds it to bf16 on load;
activations between layers are bf16 channels-last (B, H, T, 8); the last
layer writes NCHW in the stack's dtype from the bf16-rounded value
(`y.astype(self.dtype)` in the JAX package); accumulation is float32.

`conv7_layer` launches the kernel for a CUDA tensor (or raises) and runs
its plain PyTorch version only for a CPU tensor; `conv7_layer.launches`
counts kernel launches. `conv7_layer_plain` and `fused_convstack_plain`
compute the same functions: with bf16 weights they reproduce the
kernel's numerics (bf16 operands, f32 sums, bf16 activations), with
float32 weights they are the exact folded stack (tests pin it to the flax
ConvStack).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import _build
from .equivariant import circular_pad
from .stack_epilogue import LEAKY_SLOPE, fold_bn_affine

C = 8          # supported output channels; inputs pad up to this width
KERNEL = 7
PACKED = (KERNEL, 4, 2, C, C)      # [dh][tap pair][half][co][ci]
STACK_DTYPES = (torch.float32, torch.bfloat16)


def fold_layer(weight, bias, gamma, beta, mean, var, eps: float = 1e-5):
    """Conv (OIHW) + eval BatchNorm -> folded (weight, bias) in float32."""
    s, t = fold_bn_affine(gamma, beta, mean, var, eps)
    return weight.float() * s[:, None, None, None], bias.float() * s + t


def pack_weight(weight: torch.Tensor) -> torch.Tensor:
    """(..., 8, ci, 7, 7) folded weight -> (..., 7, 4, 2, 8, 8) in kernel
    C's B-fragment order: [dh][p][half][co][ci] = weight[co, ci, dh,
    2p + half]; tap dt = 7 and ci >= ci_true are zero."""
    w = F.pad(weight, (0, 1, 0, 0, 0, C - weight.shape[-3]))
    w = w.unflatten(-1, (4, 2))                 # (..., co, ci, dh, p, half)
    n = w.dim() - 5
    return w.permute(*range(n), n + 2, n + 3, n + 4, n, n + 1).contiguous()


def unpack_weight(wp: torch.Tensor) -> torch.Tensor:
    """pack_weight's (7, 4, 2, 8, 8) -> the (8, 8, 7, 7) OIHW weight, the
    padded input channels included (zero)."""
    return wp.reshape(KERNEL, 2 * 4, C, C).permute(2, 3, 0, 1)[..., :KERNEL]


@functools.lru_cache(maxsize=64)
def _pack_map(cins: tuple, device: str):
    """pack_stack's gather: for each element of the packed (L, 7, 4, 2, 8,
    8) weights, its index in pack_stack's flat tensor (a zero, then every
    layer's weight, then the biases), or 0 where pack_weight pads; and
    that leading zero. Cached per stack geometry and device (a mesh of 8
    cards serving the multi-scale ensemble holds 16)."""
    codes, n = [], 1
    for ci in cins:
        w = torch.arange(n, n + C * ci * KERNEL * KERNEL, dtype=torch.float64)
        codes.append(pack_weight(w.reshape(C, ci, KERNEL, KERNEL)))
        n += w.numel()
    return (torch.stack(codes).long().to(device),
            torch.zeros(1, device=device))


def pack_stack(layers, dtype: torch.dtype = torch.bfloat16):
    """[(weight (8, ci, 7, 7), bias (8,)) folded in float32, ...] ->
    (weights (L, 7, 4, 2, 8, 8) in dtype, pack_weight's order; biases
    (L, 8) float32), for the whole stack in three kernels: one
    concatenation, one cast and one gather."""
    idx, zero = _pack_map(tuple(w.shape[1] for w, _ in layers),
                          str(layers[0][0].device))
    flat = torch.cat([zero.to(layers[0][0].dtype)]
                     + [w.reshape(-1) for w, _ in layers]
                     + [b.reshape(-1) for _, b in layers])
    n = flat.numel() - C * len(layers)
    return flat.to(dtype)[idx], flat[n:].view(len(layers), C).float()


def conv7_layer_plain(x: torch.Tensor, wp: torch.Tensor, bias: torch.Tensor,
                      nchw_in: bool = False,
                      nchw_out: torch.dtype | None = None) -> torch.Tensor:
    """Plain version of kernel C. x (B, H, T, 8) channels-last, or
    (B, ci, H, T) with nchw_in; wp pack_weight's (7, 4, 2, 8, 8); bias
    (8,). Computed in float32 from x rounded to wp's dtype; the result is
    rounded to wp's dtype and returned channels-last in it, or NCHW
    (B, 8, H, T) in nchw_out."""
    xf = (x if nchw_in else x.permute(0, 3, 1, 2)).to(wp.dtype).float()
    w = unpack_weight(wp)[:, :xf.shape[1]].float()
    y = F.conv2d(circular_pad(xf, 3, 3), w) + bias.float()[None, :, None, None]
    y = torch.where(y >= 0, y, LEAKY_SLOPE * y).to(wp.dtype)
    if nchw_out is None:
        return y.permute(0, 2, 3, 1).contiguous()
    return y.to(nchw_out)


def conv7_layer(x: torch.Tensor, wp: torch.Tensor, bias: torch.Tensor,
                nchw_in: bool = False,
                nchw_out: torch.dtype | None = None) -> torch.Tensor:
    """One folded conv + leaky layer (kernel C on CUDA, plain on CPU).

    x (B, H, T, 8) bf16 channels-last, or (B, ci, H, T) float32 or bf16
    with nchw_in; wp (7, 4, 2, 8, 8) bf16 (pack_weight); bias (8,)
    float32. Returns (B, H, T, 8) bf16, or (B, 8, H, T) in nchw_out
    (float32 or bf16).
    """
    if x.is_cpu:
        return conv7_layer_plain(x, wp, bias, nchw_in, nchw_out)
    if not x.is_cuda:
        raise ValueError(f"conv7_layer: unsupported device {x.device}")
    dims = tuple(x.shape) if x.dim() == 4 else (0, 0, 0, 0)
    _, ci, H, T = dims if nchw_in else (dims[0], dims[3], *dims[1:3])
    if (not x.is_contiguous()
            or x.dtype not in (STACK_DTYPES if nchw_in else (torch.bfloat16,))
            or (not nchw_in and (ci != C or x.data_ptr() % 16))
            or min(H, T) < 3 or not 1 <= ci <= C
            or nchw_out not in (None, *STACK_DTYPES)
            or wp.dtype != torch.bfloat16 or tuple(wp.shape) != PACKED
            or not wp.is_contiguous() or bias.dtype != torch.float32
            or bias.shape != (C,) or not bias.is_contiguous()):
        raise ValueError(f"conv7_layer: unsupported x {x.dtype} "
                         f"{tuple(x.shape)} (nchw_in={nchw_in}, nchw_out="
                         f"{nchw_out}), weight {wp.dtype} {tuple(wp.shape)}, "
                         f"bias {bias.dtype} {tuple(bias.shape)}")
    y = _build.op("conv7")(x, wp, bias, nchw_in, nchw_out)
    conv7_layer.launches += 1
    return y


conv7_layer.launches = 0


def _stack(x: torch.Tensor, layers, layer, dtype: torch.dtype):
    if x.dtype not in STACK_DTYPES:
        raise ValueError(f"fused_convstack: unsupported dtype {x.dtype}")
    wp, bias = pack_stack(layers, dtype)
    last = len(layers) - 1
    h = x
    for i in range(len(layers)):
        h = layer(h, wp[i], bias[i], i == 0, x.dtype if i == last else None)
    return h


def fused_convstack(x: torch.Tensor, layers) -> torch.Tensor:
    """Serving-path ConvStack: x (B, Cin, H, T) float32 or bf16 ->
    (B, 8, H, T) in x's dtype, one kernel C launch per layer through bf16
    activations. layers: [(weight (8, ci, 7, 7), bias (8,)), ...] folded
    in float32."""
    return _stack(x, layers, conv7_layer, torch.bfloat16)


def fused_convstack_plain(x: torch.Tensor, layers,
                          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """fused_convstack's plain version, in the working dtype: bf16 is the
    kernels' numerics, float32 the exact folded stack."""
    return _stack(x, layers, conv7_layer_plain, dtype)
