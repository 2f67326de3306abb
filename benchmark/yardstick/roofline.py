"""Roofline arithmetic: the least time the card could take for a kernel's
call, from the call's shapes and the card's published peaks.

Frozen copies of the port's chip checks (`chip_smoke.py`: `bound`,
`tf32_products`, `window_cover`, `cqt_bounds`, `layer_bytes`,
`stack_bytes` and the peaks), rewritten to take shapes instead of the
program's tensors and layouts, so that a later change to the program
cannot move the yardstick. `tests/test_bench_yardstick.py` holds each
copy to its source at the shapes the port's batch phase measured.

Each input byte is counted read once and each output byte written once;
operations count at the peak of their type (NVIDIA H100 SXM, dense).
"""

from __future__ import annotations

import math

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12          # float32 outside the tensor cores
TF32_FLOPS = 495e12        # TF32 tensor cores, dense
BF16_FLOPS = 989e12        # bf16 tensor cores, dense

HALFBAND_TAPS = 49
BANK_ROWS = 72             # kernel B's bank: 2 * bins/octave rows, at most 72
C1_HZ = 32.70319566257483


def bound(nbytes: float, flops: float = 0.0, peak: float = F32_FLOPS) -> dict:
    """The larger of bytes over the memory rate and operations over the
    peak rate of their type, in seconds, and which of the two it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return {"bound_s": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def tf32_products(itemsize_is_bf16: bool) -> int:
    """TF32 products kernel B issues per multiply-add to keep float32
    accuracy (3xTF32): a bf16 sample is exact in TF32 (2 products), an
    int16 or float32 sample is split too (3)."""
    return 2 if itemsize_is_bf16 else 3


def window_cover(starts, n_fft: int) -> int:
    """Samples that the windows [s, s + n_fft) of ascending starts cover."""
    st = np.asarray(starts, np.int64)
    return int(n_fft + np.minimum(np.diff(st), n_fft).sum())


def n_fft(sr: int, bins_per_octave: int, octaves: int,
          fmin: float = C1_HZ) -> int:
    """Frame length of the CQT's top-octave bank: the longest filter of
    the top octave (Q * sr / f) rounded up to a power of two."""
    q = 1.0 / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    f_low = fmin * 2.0 ** ((octaves - 1) * bins_per_octave / bins_per_octave)
    longest = int(math.ceil(q * sr / f_low))
    return 1 << (longest - 1).bit_length()


def stream_lengths(L: int, octaves: int) -> list[int]:
    """Samples of each octave's stream: each decimation keeps ceil(L/2)."""
    lens = [L]
    for _ in range(1, octaves):
        lens.append((lens[-1] - 1) // 2 + 1)
    return lens


def padded_length(L: int, nfft: int) -> int:
    """Rows of an octave's padded buffer (L + n_fft + 1, rounded up to 8)."""
    return -(-(L + nfft + 1) // 8) * 8


def frame_starts(hop: int, octave: int, n_frames: int) -> list[int]:
    """Window starts of octave `octave`: floor(t * hop / 2**o + 0.5)."""
    return [math.floor(t * hop / 2 ** octave + 0.5) for t in range(n_frames)]


def cqt_bounds(B: int, L: int, *, sr: int, hop: int, bins_per_octave: int,
               octaves: int, input_itemsize: int, stream_itemsize: int,
               input_bf16: bool = False, stream_bf16: bool = True
               ) -> tuple[dict, dict]:
    """Bounds of kernel A's octaves - 1 steps together and of kernel B's
    one launch for a (B, L) batch: A reads each octave's interior once and
    writes each padded stream (49 float32 multiply-adds per computed row,
    outside the tensor cores); B reads the samples its windows cover, the
    bank's two parts and the tables, writes the features, and does the
    GEMM (2 bpo * n_fft multiply-adds a frame) as the TF32 products it
    must issue for float32 accuracy, at the TF32 peak."""
    nfft = n_fft(sr, bins_per_octave, octaves)
    head = nfft // 2
    lens = stream_lengths(L, octaves)
    lengths = [padded_length(n, nfft) for n in lens]
    T = 1 + L // hop
    a_bytes = a_flops = 0
    for o in range(1, octaves):
        a_bytes += B * lens[o - 1] * (input_itemsize if o == 1
                                      else stream_itemsize) \
            + B * lengths[o] * stream_itemsize
        a_flops += 2 * HALFBAND_TAPS * B * (lens[o] + 2 * head + 1)
    n_bins = octaves * bins_per_octave
    b_bytes = 2 * nfft * BANK_ROWS * 4 + octaves * T * 4 \
        + n_bins * 4 + B * n_bins * T * 4
    for o in range(octaves):
        b_bytes += B * window_cover(frame_starts(hop, o, T), nfft) * (
            input_itemsize if o == 0 else stream_itemsize)
    b_flops = 2 * B * T * 2 * bins_per_octave * nfft * (
        tf32_products(input_bf16)
        + (octaves - 1) * tf32_products(stream_bf16))
    return bound(a_bytes, a_flops), bound(b_bytes, b_flops, TF32_FLOPS)


def layer_bytes(B: int, H: int, T: int, cin: int, n: int) -> list[int]:
    """What each of the n >= 2 layers of the fused stack must move: the
    first reads the float32 NCHW input and writes bf16 channels-last (8
    channels), the middle ones read and write bf16 channels-last, the last
    writes the float32 NCHW output."""
    per_pos = [cin * 4 + 16] + [16 + 16] * (n - 2) + [16 + 8 * 4]
    return [B * H * T * p for p in per_pos]


def stack_bytes(B: int, H: int, T: int, cin: int, n: int) -> int:
    """What the fused stack must move: the float32 NCHW input read once,
    each bf16 channels-last intermediate written once and read once, the
    float32 NCHW output written once."""
    return B * H * T * (cin * 4 + (n - 1) * 2 * 8 * 2 + 8 * 4)


def stack_flops(B: int, H: int, T: int, cins, cout: int = 8,
                kernel: int = 7) -> int:
    """The stack's multiply-adds as operations: 2 * k * k * cout * cin a
    position and layer (the inputs' own channels, not the kernel's
    padding)."""
    return sum(2 * kernel * kernel * cout * ci * B * H * T for ci in cins)


def stack_bound(B: int, H: int, T: int, cins) -> dict:
    """Kernel C's bound for one stack: its bytes, or its bf16 operations
    at the bf16 tensor-core peak, whichever is larger."""
    return bound(stack_bytes(B, H, T, cins[0], len(cins)),
                 stack_flops(B, H, T, cins), BF16_FLOPS)
