"""The training step's share of the card's float32 peak (67 TFLOP/s):
the forward and backward FLOPs of every song the window's steps trained
on, counted by FlopCounterMode over the reference model at each song's
own, unpadded length, over the window."""

from benchmark.yardstick.roofline import F32_FLOPS

LAYER = "training step (train.trainer)"
UNIT = "%"
MOVES = "train_songs_per_s"
SOURCE = "host_clock"
READS = "the songs of the window's steps and the window's length"


def read(r):
    if r.window_s <= 0 or not r.window_clips:
        return None
    return 100.0 * r.window_flops() / r.window_s / F32_FLOPS
