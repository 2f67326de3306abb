"""Stage split of the CQT response kernel (kernel B) on a CUDA card (the
counterpart of the JAX package's scripts/probe_cqt_kernel_stages.py).

Runs kernel B cut off after each stage (cqt_cuda.octave_response_stage,
csrc/cqt_response.cu), same grid, same window staging:

  load     windows staged at the 16-aligned start; writes raw samples
  realign  windows staged at the exact start; writes raw samples
  gemm     bank + windows staged, the [cos|sin] GEMM (aligned windows)
  full     the production kernel (GEMM + magnitude + scale + log1p)

(realign - load) is the cost of the exact-start addressing, (gemm - load)
the bank staging and FMA, (full - gemm) the epilogue. The window bytes
are set against the card's own copy rate, measured here as a
device-to-device copy of the octave's stream. Octave o > 0 streams come
from kernel A (cqt_cuda.cascade_arena) at AKX_STREAM_DTYPE. Times are CUDA
events: a warm-up, then the median of AKX_REPS runs.

Run on the card:  AKX_B=512 AKX_OCTAVE=0 python -m audio_key_estimation_torch.scripts.probe_cqt_kernel_stages
"""

from __future__ import annotations

import os

import torch

from audio_key_estimation_torch.ops import cqt_cuda as K
from audio_key_estimation_torch.ops.cqt import (CQTParams, kernel_bank,
                                                pad_stream)
from audio_key_estimation_torch.scripts.harness import (card_line, log,
                                                        require_cuda, time_ms)

SR = 44100
CLIP_SECONDS = int(os.environ.get("AKX_CLIP", 120))
B = int(os.environ.get("AKX_B", 512))
REPS = int(os.environ.get("AKX_REPS", 4))
OCTAVE = int(os.environ.get("AKX_OCTAVE", 0))
STREAM_DTYPE = os.environ.get("AKX_STREAM_DTYPE", "bfloat16")
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def octave_inputs(p: CQTParams, y: torch.Tensor, octave: int,
                  stream_dtype: torch.dtype):
    """(padded stream, starts, bank, scales) of one octave of int16 clips
    y, the stream built as cqt_cuda builds it (a slice of kernel A's
    arena for octave > 0), the constants cqt_cuda's."""
    n_fft = kernel_bank(p)["n_fft"]
    head = n_fft // 2
    in_scale = 1.0 / 32768.0
    layout = K.arena_layout(y.shape[1], octave + 1, n_fft)
    x0 = pad_stream(y, head, layout.lengths[0])
    arena = K.cascade_arena(x0, layout, head, in_scale, stream_dtype)
    c = K._constants(p, 1 + y.shape[1] // p.hop, in_scale, str(y.device))
    return (K.octave_streams(x0, arena, layout)[octave], c.starts[octave],
            c.bank, c.scales[octave])


def main(sr: int = SR, clip: int = CLIP_SECONDS, batch: int = B,
         reps: int = REPS, octave: int = OCTAVE,
         stream_dtype: str = STREAM_DTYPE) -> dict:
    """{stage: ms} plus the copy rate and the window bytes' floor."""
    device = require_cuda("probe_cqt_kernel_stages")
    sd = _DTYPES[stream_dtype]
    p = CQTParams(sr=sr, hop=round(sr / 5))
    n_fft = kernel_bank(p)["n_fft"]
    L = sr * clip
    g = torch.Generator(device=device).manual_seed(0)
    y = (torch.randn(batch, L, generator=g, device=device) * 8000).clamp(
        -32768, 32767).to(torch.int16)
    buf, starts, bank, scales = octave_inputs(p, y, octave, sd)
    del y
    T = starts.shape[0]
    item = buf.element_size()
    win_bytes = T * (n_fft + 16) * batch * item
    dst = torch.empty_like(buf)
    copy_ms = time_ms(lambda: dst.copy_(buf), reps)
    del dst
    rate = 2 * buf.numel() * item / (copy_ms * 1e-3) / 1e9
    res = {"copy_GBps": rate, "floor_ms": win_bytes / 1e9 / rate * 1e3}
    log(f"kernel B stage probe on {torch.cuda.get_device_name(0)} "
        f"({card_line()}): sr={sr}, B={batch}, octave={octave}, "
        f"n_fft={n_fft}, T={T}, stream {buf.dtype}")
    log(f"geometry: window bytes {win_bytes / 1e9:.4f} GB -> "
        f"{res['floor_ms']:.4f} ms floor at this card's measured copy rate "
        f"{rate:.0f} GB/s (read + write of the stream)")
    for stage in K.STAGES:
        res[stage] = time_ms(lambda: K.octave_response_stage(
            buf, starts, bank, scales, stage), reps)
        log(f"  {stage:8s}: {res[stage]:9.4f} ms")
    log(f"deltas: realign {res['realign'] - res['load']:.4f} ms, "
        f"bank+gemm {res['gemm'] - res['load']:.4f} ms, "
        f"epilogue {res['full'] - res['gemm']:.4f} ms")
    return res


if __name__ == "__main__":
    main()
