"""Host decode: milliseconds of `audio_io.decode_many` (as predict_files
calls it) a useful audio-minute served, over the traced run's window."""

LAYER = "host decode (data.audio_io.decode_many)"
UNIT = "ms/audio-min"
MOVES = "served_audio_min_per_s"
SOURCE = "host_clock"
READS = "the benchmark's host span around decode_many"


def read(r):
    return r.span_ms_per_minute("decode")
