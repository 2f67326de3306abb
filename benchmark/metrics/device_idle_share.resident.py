"""The device's idle share while the resident cells serve: the share of the
profiled slice of requests in which no kernel or copy ran on the card."""

LAYER = "device"
UNIT = "%"
MOVES = "device_audio_min_per_s"
SOURCE = "device_trace"
READS = "every device row of the profiled slice, against its host wall"


def read(r):
    return r.idle_share()
