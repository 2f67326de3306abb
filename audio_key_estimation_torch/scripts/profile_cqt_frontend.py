"""What sets the card time of the CQT front-end's kernels A and B at the
serving geometry: 120 s PCM16 clips at 22050 Hz, hop 4410, 36 bins x 8
octaves, n_fft 512, bf16 streams (what chip_smoke.py phase 3 times at 16
clips).

    python -m audio_key_estimation_torch.scripts.profile_cqt_frontend

Every time is the card's (harness.graph_ms): the call captured REPEAT
times into one CUDA graph, the replay timed with CUDA events (median of
20) and divided by REPEAT, so neither the host's wrapper calls nor the
graph's own launch are counted. Rows, on stderr:

  clips b   kernel A's step into each octave and kernel B's one launch at
            b clips, with their blocks: the grid grows with b and the
            work of a block does not, so a time flat in b is the latency
            of one block (plus its launch) and a time that grows with b
            is throughput;
  stage     kernel B cut off after each stage on one octave at the most
            clips (#6, the same template, one octave per launch): load
            is window staging, gemm - realign the bank staging and mma,
            full - gemm the epilogue;
  empty     #8 at grid 1: one launch inside a graph, no work.

Exits non-zero without CUDA.
"""

from __future__ import annotations

import torch

from audio_key_estimation_torch.ops import cqt_cuda as K
from audio_key_estimation_torch.ops import probes_cuda as PC
from audio_key_estimation_torch.ops.cqt import (CQTParams, decimation_taps,
                                                kernel_bank, pad_stream)
from audio_key_estimation_torch.scripts.harness import (card_line, graph_ms,
                                                        log, require_cuda)

SR = 22050
CLIP_SECONDS = 120
CLIPS = (1, 2, 4, 8, 16)
REPEAT = 10
A_ROWS_PER_BLOCK = 2048     # csrc/cqt_decimate.cu kTile
B_FRAMES_PER_BLOCK = 128    # csrc/cqt_response.cu kFrames
B_BLOCKS_PER_SM = 3         # its __launch_bounds__ (57 KB of shared memory)


def main(clip: int = CLIP_SECONDS, clips: tuple = CLIPS,
         repeat: int = REPEAT) -> dict:
    """{"A": {b: [ms per step]}, "B": {b: ms}, "stages": {octave: {stage:
    ms}}, "empty_ms": ms}."""
    device = require_cuda("profile_cqt_frontend")
    p = CQTParams(sr=SR, hop=round(SR / 5))
    n_fft = kernel_bank(p)["n_fft"]
    head = n_fft // 2
    in_scale = 1.0 / 32768.0
    L = SR * clip
    T = 1 + L // p.hop
    g = torch.Generator(device=device).manual_seed(0)
    y = (torch.randn(max(clips), L, generator=g, device=device) * 8000).clamp(
        -32768, 32767).to(torch.int16)
    lay = K.arena_layout(L, p.octaves, n_fft)
    c = K._constants(p, T, in_scale, str(device))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    log(f"CQT front-end on {torch.cuda.get_device_name(0)} ({card_line()}), "
        f"{sms} SMs: {clip} s clips, T={T}, n_fft={n_fft}, bf16 streams; "
        f"card ms per call, {repeat} calls per graph")
    res = {"A": {}, "B": {}, "stages": {}}
    for b in clips:
        x0 = pad_stream(y[:b].contiguous(), head, lay.lengths[0])
        arena = K.cascade_arena(x0, lay, head, in_scale, torch.bfloat16)
        streams = K.octave_streams(x0, arena, lay)
        res["A"][b] = [graph_ms(lambda o=o: K.cascade_pad(
            streams[o - 1], head, lay.lens[o - 1], lay.lens[o], streams[o],
            decimation_taps(o, in_scale)), repeat=repeat)
            for o in range(1, p.octaves)]
        out = torch.empty(b, p.n_bins, T, device=device)
        res["B"][b] = graph_ms(lambda: K.octave_response(
            x0, arena, lay, c.starts, c.bank, c.scales, out), repeat=repeat)
        a_blocks = [-(-n // A_ROWS_PER_BLOCK) * b for n in lay.lengths[1:]]
        b_blocks = -(-T // B_FRAMES_PER_BLOCK) * b * p.octaves
        log(f"clips {b:2d}: A steps " + ", ".join(
            f"o{o} {t:.4f} [{n}]" for o, (t, n) in
            enumerate(zip(res["A"][b], a_blocks), 1))
            + f" (sum {sum(res['A'][b]):.4f}); B {res['B'][b]:.4f} "
            f"[{b_blocks} blocks, {b_blocks / (B_BLOCKS_PER_SM * sms):.2f} "
            f"waves at {B_BLOCKS_PER_SM} per SM]")
    for o, buf in enumerate(streams):
        res["stages"][o] = {s: graph_ms(lambda s=s: K.octave_response_stage(
            buf, c.starts[o], c.bank, c.scales[o], s), repeat=repeat)
            for s in K.STAGES}
        log(f"stage, octave {o} ({buf.dtype}, {max(clips)} clips): " + ", ".join(
            f"{s} {t:.4f}" for s, t in res["stages"][o].items()))
    tot = {s: sum(r[s] for r in res["stages"].values()) for s in K.STAGES}
    log("stage, 8 octaves summed: " + ", ".join(
        f"{s} {t:.4f}" for s, t in tot.items())
        + f"; gemm - realign {tot['gemm'] - tot['realign']:.4f}, "
        f"full - gemm {tot['full'] - tot['gemm']:.4f}")
    x = torch.zeros(1 << 12, 512, dtype=torch.int16, device=device)
    res["empty_ms"] = graph_ms(lambda: PC.launch_probe(x, 1), repeat=repeat)
    log(f"empty: #8 at grid 1 {res['empty_ms']:.5f} ms per launch")
    return res


if __name__ == "__main__":
    main()
