"""The float32 precision of cuDNN convolutions and cuBLAS matmuls.

The configurations state IEEE float32: a run sets it for the whole
process (`ieee`), and the check's control runs the reference under TF32
(`tf32`), the nearest precision below it. The legacy flags are the only
interface used here, so the settings never disagree.
"""

from __future__ import annotations

import contextlib

import torch


def _set(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def ieee() -> None:
    """IEEE float32 for the rest of the process."""
    _set(False)


@contextlib.contextmanager
def tf32():
    """TF32 inside the body, IEEE float32 after it."""
    _set(True)
    try:
        yield
    finally:
        _set(False)
