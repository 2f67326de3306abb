"""The device's idle share while training: the share of two profiled
steps in which no kernel or copy ran on the card."""

LAYER = "device"
UNIT = "%"
MOVES = "train_songs_per_s"
SOURCE = "device_trace"
READS = "every device row of the profiled steps, against their host wall"


def read(r):
    return r.idle_share()
