"""IEEE float32 inside the port's entry points.

The JAX package computes float32 as IEEE float32, and the port's parity
bars (model logits rtol 1e-4, wav -> logits key < 1e-3) are float32 bars.
Under torch's defaults cuDNN runs float32 convolutions as TF32 (10
mantissa bits), so `KeyEstimator.outputs`, the trainer's steps,
`KeyDataset`'s CQT and `cli/equivariance.py` enter `ieee_float32()`:
inside it cuDNN convolutions and cuBLAS matmuls run in IEEE float32, and
the caller's settings come back on exit, after an exception too. bf16
work is unaffected (the flags govern float32 only), and so are the
hand-written kernels, which set their own precision (kernel B's 3xTF32).

torch >= 2.9 has two interfaces to the same switches: the legacy
`torch.backends.cudnn.allow_tf32` / `cuda.matmul.allow_tf32` flags and
the per-operator `fp32_precision` settings. Reading a legacy flag raises
when the two disagree, so the pin sets both consistently: the legacy
cuDNN and cuBLAS flags off (where the caller's state lets them be read),
then the convolution, RNN and matmul `fp32_precision` to "ieee", which an
explicit per-operator setting wins over any parent ("cuda", "generic")
value. On exit each legacy flag comes back first (setting one resets its
per-operator values), then the per-operator values.
"""

from __future__ import annotations

import contextlib
import functools
import logging

import torch

log = logging.getLogger(__name__)


def flags() -> dict:
    """The float32 precision settings cuDNN and cuBLAS read: the
    per-operator fp32_precision of cuDNN convolutions and RNNs and of
    cuBLAS matmuls, and the legacy cuDNN and cuBLAS flags (None where
    one cannot be read: the caller mixed the two interfaces)."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    return {"cudnn.conv": cudnn.conv.fp32_precision,
            "cudnn.rnn": cudnn.rnn.fp32_precision,
            "cuda.matmul": matmul.fp32_precision,
            "cudnn.allow_tf32": _legacy(cudnn),
            "cuda.matmul.allow_tf32": _legacy(matmul)}


def _legacy(backend):
    try:
        return backend.allow_tf32
    except RuntimeError:   # the legacy flag and the new settings disagree
        return None


@functools.cache
def _log_once(entry: str, caller: tuple) -> None:
    log.info("%s: float32 in IEEE float32 (cuDNN conv, cuBLAS matmul); "
             "the caller's settings %s", entry, dict(caller))


@contextlib.contextmanager
def ieee_float32(entry: str = ""):
    """cuDNN convolutions (and RNNs) and cuBLAS matmuls in IEEE float32
    for the body; the caller's settings restored on exit. `entry` names
    the entry point in the one log line per distinct caller setting."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = flags()
    if entry:
        _log_once(entry, tuple(saved.items()))
    try:
        if saved["cudnn.allow_tf32"] is not None:
            cudnn.allow_tf32 = False
        if saved["cuda.matmul.allow_tf32"] is not None:
            matmul.allow_tf32 = False
        cudnn.conv.fp32_precision = "ieee"
        cudnn.rnn.fp32_precision = "ieee"
        matmul.fp32_precision = "ieee"
        yield
    finally:
        if saved["cudnn.allow_tf32"] is not None:
            cudnn.allow_tf32 = saved["cudnn.allow_tf32"]
        if saved["cuda.matmul.allow_tf32"] is not None:
            matmul.allow_tf32 = saved["cuda.matmul.allow_tf32"]
        cudnn.conv.fp32_precision = saved["cudnn.conv"]
        cudnn.rnn.fp32_precision = saved["cudnn.rnn"]
        matmul.fp32_precision = saved["cuda.matmul"]
