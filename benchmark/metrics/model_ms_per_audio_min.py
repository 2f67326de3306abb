"""The model's device time a useful audio-minute: the device rows
launched inside the benchmark's `bench.model` range (est.model) in the
profiled calls, over those calls' audio-minutes."""

from benchmark.yardstick.profile import rows_in

LAYER = "model (models.pitchclassnet, models.multi_scale)"
UNIT = "ms/audio-min"
MOVES = "device_audio_min_per_s"
SOURCE = "device_trace"
READS = "device rows launched in the bench.model ranges of the profiled calls"


def read(r):
    rows = rows_in(r.profile, "bench.model")
    if not rows or r.call_minutes <= 0:
        return None
    return sum(x.end_us - x.start_us for x in rows) / 1e3 / r.call_minutes
