"""Batch + H2D: milliseconds of `KeyEstimator.make_batch` (host_batch's
packing, then the pageable copy, ended by a synchronize) a useful
audio-minute served, over the traced run's window."""

LAYER = "batch + H2D (predict.KeyEstimator.make_batch)"
UNIT = "ms/audio-min"
MOVES = "served_audio_min_per_s"
SOURCE = "host_clock"
READS = "the benchmark's host span around make_batch, ended by a synchronize"


def read(r):
    return r.span_ms_per_minute("batch_h2d")
