"""The batch's copy to the card: bytes the program's `akx.h2d` spans
(`KeyEstimator.make_batch`'s copies) moved in the profiled slice, over
the device time of the slice's host-to-device copy rows. The copy's own
time on the card, so a copy that returns before it is done (pinned,
non-blocking) reads as fast as the copy engine ran, no faster."""

from benchmark import program

LAYER = "batch + H2D (predict.KeyEstimator.make_batch)"
UNIT = "GB/s"
MOVES = "served_audio_min_per_s"
SOURCE = "device_trace"
READS = ("the bytes of the program's akx.h2d spans and the device time "
         "of the Memcpy HtoD rows in the slice")


def read(r):
    found = program.spans("akx.request")
    if found is None:
        return None
    moved = sum(x.counts.get("bytes", 0) for x in found
                if x.name == "akx.h2d")
    us = sum(x.end_us - x.start_us for x in r.profile.rows
             if x.name.startswith("Memcpy HtoD"))
    if us <= 0 or moved <= 0:
        return None
    return moved / us / 1e3
