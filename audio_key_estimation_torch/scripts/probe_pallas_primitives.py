"""The six primitive probes on a CUDA card (the counterpart of the JAX
package's scripts/probe_pallas_primitives.py).

Each probe runs its kernel of csrc/probe_primitives.cu on the probe's own
input and holds the result against the array the TPU probe expects
(numpy, independent of the port), printing OK or FAIL per probe:

  P1  value reshape (8, 128) -> (4, 256)
  P2  strided rows: [x[0::2] | x[1::2]]
  P3  int16 load + convert to float32 (x / 32768)
  P4  copy at a dynamic 1-D offset (row i from i*128 + 64), x 2
  P4b copy of 16 rows at a dynamic row offset (i*8 + 3), + 1
  P5  window concat [x[:8] | x[1:9, :48]]

Run on the card:  python -m audio_key_estimation_torch.scripts.probe_pallas_primitives
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from audio_key_estimation_torch.ops import probes_cuda as PC
from audio_key_estimation_torch.scripts.harness import (card_line, log,
                                                        require_cuda)

LABELS = {
    "p1_reshape": "P1 reshape (n,128)->(n/2,256)",
    "p2_strided": "P2 strided sublane slice [0::2]",
    "p3_int16": "P3 int16 load+convert",
    "p4_dma": "P4 dynamic-offset 1D DMA",
    "p4b_dma_2d": "P4b dynamic-row 2D DMA",
    "p5_window": "P5 window concat (lane slices)",
}


def expected(name: str, x: np.ndarray) -> np.ndarray:
    """The TPU probe's own numpy reference for input x."""
    if name == "p1_reshape":
        return x.reshape(4, 256)
    if name == "p2_strided":
        return np.concatenate([x[0::2], x[1::2]], axis=1)
    if name == "p3_int16":
        return x.astype(np.float32) / 32768
    if name == "p4_dma":
        return np.stack([x[i, i * 128 + 64:i * 128 + 320] * 2
                         for i in range(4)])
    if name == "p4b_dma_2d":
        return np.stack([x[i * 8 + 3:i * 8 + 19] + 1 for i in range(4)])
    return np.concatenate([x[:8], x[1:9, :48]], axis=1)


def main() -> dict:
    """Run the six probes; {name: max |kernel - expected|}."""
    device = require_cuda("probe_pallas_primitives")
    log(f"probing on {torch.cuda.get_device_name(0)} ({card_line()})")
    errs = {}
    for name, label in LABELS.items():
        x = PC.primitive_input(name)
        got = PC.primitive(name, x.to(device)).cpu().numpy()
        ref = expected(name, x.numpy())
        errs[name] = (float(np.abs(got - ref).max())
                      if got.shape == ref.shape else float("inf"))
        if errs[name] == 0.0:
            log(f"{label}: OK")
        else:
            log(f"{label}: FAIL — shape {got.shape} vs {ref.shape}, "
                f"max |d| {errs[name]}")
    return errs


if __name__ == "__main__":
    sys.exit(0 if all(e == 0.0 for e in main().values()) else 1)
