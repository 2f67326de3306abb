"""The whole call's share of the card's float32 peak (67 TFLOP/s): the
useful FLOPs of every clip served in the traced run's window, the CQT
by its definition and the model counted by FlopCounterMode over the
reference model, each clip at its own unpadded length, over the window."""

from benchmark.yardstick.roofline import F32_FLOPS

LAYER = "whole step"
UNIT = "%"
MOVES = "device_audio_min_per_s"
SOURCE = "host_clock"
READS = "the clips served in the window and the window's length"


def read(r):
    if r.window_s <= 0 or not r.window_clips:
        return None
    return 100.0 * r.window_flops() / r.window_s / F32_FLOPS
