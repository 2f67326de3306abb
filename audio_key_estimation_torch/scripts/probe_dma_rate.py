"""Window-copy rate on a CUDA card (the counterpart of the JAX package's
scripts/probe_dma_rate.py).

Stages the CQT's octave-0 frame windows (win = n_fft + 16 int16 samples
per clip, tile_t frames per step, tile_t from the TPU response kernel's
plan) from the batch-major (B, Lpad) stream into shared memory, in each
copy pattern of csrc/probe_window_copy.cu:

  grid        no copies (launch and block scheduling alone)
  dma1        1 window per step
  dma3        tile_t windows per step (the production chain)
  dma3_static tile_t windows at offsets from the block index alone
              (spacing probes_cuda.static_stride: 8816 at 44.1 kHz, as on
              the TPU, where every window still ends inside the stream)
  dma3_big    one contiguous span of tile_t * win per step
  dma3_db     tile_t windows per step, double-buffered across steps

and prints each variant's time and the rate of the bytes it stages:
eager (CUDA events around one call, host included: a warm-up, then the
median of AKX_REPS runs) and on the card (the call replayed from a CUDA
graph, `harness.graph_ms`). Each window is one bulk copy into shared
memory completing on an mbarrier (csrc/probe_window_copy.cu).

Run on the card:  AKX_B=512 python -m audio_key_estimation_torch.scripts.probe_dma_rate
"""

from __future__ import annotations

import os

import torch

from audio_key_estimation_torch.ops import probes_cuda as PC
from audio_key_estimation_torch.ops.cqt import (CQTParams, _frame_starts,
                                                kernel_bank, pad_stream)
from audio_key_estimation_torch.scripts.harness import (card_line, graph_ms,
                                                        log, require_cuda,
                                                        time_ms)

SR = 44100
CLIP_SECONDS = int(os.environ.get("AKX_CLIP", 120))
B = int(os.environ.get("AKX_B", 512))
REPS = int(os.environ.get("AKX_REPS", 4))


def geometry(sr: int, clip: int, batch: int):
    """(n_fft, hop, L, tile_t, starts padded to t_pad, stream length)."""
    p = CQTParams(sr=sr, hop=round(sr / 5))
    n_fft = kernel_bank(p)["n_fft"]
    L = sr * clip
    n_frames = 1 + L // p.hop
    tile_t, _ = PC.response_plan(n_fft, batch, 2)
    t_pad = -(-n_frames // tile_t) * tile_t
    starts = _frame_starts(p.hop, 0, n_frames)
    starts = starts + [starts[-1]] * (t_pad - n_frames)
    # the TPU's _pad_signal_for_starts length, rounded to 16 samples so
    # every row starts 16-byte aligned
    need = max(L + n_fft + 1, starts[-1] + n_fft + PC.ALIGN)
    return n_fft, p.hop, L, tile_t, starts, -(-need // 16) * 16


def make_stream(batch: int, L: int, n_fft: int, length: int,
                device) -> torch.Tensor:
    """Seeded int16 clips, reflect-padded as the CQT pads octave 0."""
    g = torch.Generator(device=device).manual_seed(0)
    y = torch.randint(-8000, 8000, (batch, L), generator=g,
                      dtype=torch.int16, device=device)
    return pad_stream(y, n_fft // 2, length)


def main(sr: int = SR, clip: int = CLIP_SECONDS, batch: int = B,
         reps: int = REPS) -> dict:
    """{variant: (eager ms, GB/s, card ms, card GB/s)}."""
    device = require_cuda("probe_dma_rate")
    n_fft, hop, L, tile_t, starts, length = geometry(sr, clip, batch)
    win = n_fft + PC.ALIGN
    t_pad = len(starts)
    log(f"window-copy probe on {torch.cuda.get_device_name(0)} "
        f"({card_line()}): sr={sr}, hop={hop}, B={batch}, win={win}, "
        f"tile_t={tile_t}, steps={t_pad // tile_t}, window bytes "
        f"{win * batch * 2 / 1e6:.3f} MB")
    x = make_stream(batch, L, n_fft, length, device)
    starts_dev = torch.tensor(starts, dtype=torch.int32, device=device)
    stride = PC.static_stride(hop, t_pad, win, length)
    log(f"dma3_static frame spacing {stride}")
    res = {}
    for variant in PC.WINDOW_VARIANTS:
        def call():
            return PC.window_copy(x, starts_dev, variant, tile_t, win,
                                  stride)
        ms, card = time_ms(call, reps), graph_ms(call, reps)
        moved = PC.window_copy_bytes(variant, t_pad, tile_t, win, batch)
        rate, card_rate = (moved / (t * 1e-3) / 1e9 for t in (ms, card))
        res[variant] = (ms, rate, card, card_rate)
        log(f"  {variant:12s}: {ms:9.4f} ms  {rate:8.1f} GB/s eager; "
            f"{card:9.5f} ms  {card_rate:8.1f} GB/s on the card")
    return res


if __name__ == "__main__":
    main()
