"""Single switch for the CQT front-end implementation.

Serving selects the front-end through `Config.use_pallas_cqt` via this
dispatcher, so the plain PyTorch path and the CUDA kernels stay
interchangeable behind one interface (mirrors the JAX package's
ops/frontend.py). In the port the switch means "the hand-written
kernels": "auto" takes them on a CUDA device and the plain path on the
CPU; "on" on the CPU raises, because a CUDA kernel has no interpret mode.
"""

from __future__ import annotations

import torch

from .cqt import CQTParams, cqt
from .cqt_cuda import cqt_cuda

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name) -> torch.dtype:
    """Config dtype string ('float32' | 'bfloat16') -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _TORCH_DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"dtype {name!r}: expected float32 or bfloat16")


def use_cuda_kernels(setting, device: torch.device) -> bool:
    """Resolve Config.use_pallas_cqt ("auto" | "on" | "off", or a bool)
    against the device the features are computed on."""
    v = setting.strip().lower() if isinstance(setting, str) else setting
    if v in ("auto", None):
        return device.type == "cuda"
    if v in (True, "on", "true", "1"):
        if device.type != "cuda":
            raise ValueError(
                f"use_pallas_cqt={setting!r} needs a CUDA device (the CQT "
                f"kernels have no interpret mode), got {device}")
        return True
    if v in (False, "off", "false", "0"):
        return False
    raise ValueError(f"use_pallas_cqt={setting!r}: expected "
                     "'auto' | 'on' | 'off' (or a boolean)")


def feature_bins(cfg) -> tuple:
    """Bins/octave of each CQT the model consumes: (cfg.bins_per_octave,),
    and 12 beside it for the multi-scale ensemble's model2 (the JAX
    package's predict.py::_features)."""
    return ((cfg.bins_per_octave, 12) if cfg.multi_scale
            else (cfg.bins_per_octave,))


def compute_cqt(y: torch.Tensor, p: CQTParams, *, use_kernels: bool = False,
                conv_dtype="bfloat16") -> torch.Tensor:
    """Batched log1p-CQT: (B, L) -> (B, n_bins, T).

    use_kernels=True runs CUDA kernels A and B (ops/cqt_cuda.py);
    conv_dtype (`Config.cqt_conv_dtype`) is the decimated streams' storage
    dtype on either path.
    """
    if use_kernels:
        return cqt_cuda(y, p, stream_dtype=torch_dtype(conv_dtype))
    return cqt(y, p, stream_dtype=torch_dtype(conv_dtype))
