"""Transpose-pad experiment on a CUDA card (the counterpart of the JAX
package's scripts/experiment_transpose_kernel.py).

csrc/transpose_pad.cu turns a (B, L) batch of int16 clips into the
(lfull, B) time-major stream the TPU's response kernel read: transposed,
reflect-padded by librosa's centered-frame pad and zero-extended to the
TPU kernel's block multiple (`probes_cuda.transpose_pad_tm`, same lfull,
None where the TPU plan refuses). The port itself streams batch-major
and needs no transpose; this measures what one would cost. It checks the
kernel exactly against numpy on a small odd-length case, then times it
beside PyTorch's own transpose copy (`y.t().contiguous()`: a transpose
with no pad, not the same function), eager (CUDA events around one call,
host included: a warm-up, then the median of REPS runs) and on the card
(the call replayed from a CUDA graph, `harness.graph_ms`), with the
kernel's byte bound (each sample read once, each output row written
once, at 3.35 TB/s).

Run on the card:  python -m audio_key_estimation_torch.scripts.experiment_transpose_kernel
"""

from __future__ import annotations

import numpy as np
import torch

from audio_key_estimation_torch.ops import probes_cuda as PC
from audio_key_estimation_torch.scripts.harness import (card_line, graph_ms,
                                                        log, require_cuda,
                                                        time_ms)

SR = 22050
B = 256
CLIP_SECONDS = 120
REPS = 5
HBM_BYTES_PER_S = 3.35e12   # the H100 SXM's memory rate


def main(sr: int = SR, batch: int = B, clip: int = CLIP_SECONDS,
         reps: int = REPS) -> dict:
    """{"tp-kernel": ms, "tp-torch": ms} eager, the same keys with
" card" on the card, and "bound" (ms)."""
    device = require_cuda("experiment_transpose_kernel")
    log(f"transpose kernel experiment on {torch.cuda.get_device_name(0)} "
        f"({card_line()}): B={batch}, L={sr * clip}")
    g = torch.Generator(device=device).manual_seed(0)
    y = ((torch.rand(batch, sr * clip, generator=g, device=device) - 0.5)
         * 32767).to(torch.int16)
    L = y.shape[1]
    last_start = (L // 4410) * 4410

    ys = y[:128, :30001].contiguous()
    got = PC.transpose_pad_tm(ys, (30001 // 4410) * 4410, 512)
    ref = np.pad(ys.cpu().numpy().T, ((256, 257), (0, 0)), mode="reflect")
    lf = got.shape[0]
    ref = np.pad(ref, ((0, max(0, lf - ref.shape[0])), (0, 0)))[:lf]
    np.testing.assert_array_equal(got.cpu().numpy(), ref)
    log("correctness: exact")

    calls = {"tp-kernel": lambda: PC.transpose_pad_tm(y, last_start, 512),
             "tp-torch": lambda: y.t().contiguous()}
    res = {}
    for name, fn in calls.items():
        res[name] = time_ms(fn, reps)
        res[name + " card"] = graph_ms(fn, reps)
    lfull = PC.transpose_pad_geometry(y, last_start, 512)
    res["bound"] = (L + lfull) * batch * y.element_size() \
        / HBM_BYTES_PER_S * 1e3
    for name in calls:
        log(f"{name:12s} {res[name]:9.4f} ms/step eager, "
            f"{res[name + ' card']:9.4f} ms on the card")
    log(f"tp-kernel byte bound {res['bound']:.4f} ms "
        f"({res['bound'] / res['tp-kernel card']:.1%} of it on the card); "
        f"tp-torch is a transpose with no pad, not the same function")
    return res


if __name__ == "__main__":
    main()
