"""Packing: milliseconds of the program's `akx.pack` spans
(`KeyEstimator.host_batch`: `audio_io.pack_batch` into the bucket-padded
rows of the estimator's page-locked buffer on CUDA, into a fresh array
elsewhere) a useful audio-minute, over the profiled slice's requests. No
synchronize: packing is host work."""

from benchmark import program

LAYER = "batch + H2D (predict.KeyEstimator.make_batch)"
UNIT = "ms/audio-min"
MOVES = "served_audio_min_per_s"
SOURCE = "program_span"
READS = "the program's akx.pack spans in the profiled slice's requests"


def read(r):
    found = program.spans("akx.request")
    if found is None or r.call_minutes <= 0:
        return None
    return 1e3 * program.seconds(found, "akx.pack") / r.call_minutes
