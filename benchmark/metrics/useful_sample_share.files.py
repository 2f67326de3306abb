"""The useful share of the samples the program packs, copies and runs
through the CQT: the `akx.pack` counter's samples over rows x the
bucket's length, over every request the process served."""

from benchmark import program

LAYER = "batch + H2D (predict.KeyEstimator.make_batch)"
UNIT = "%"
MOVES = "served_audio_min_per_s"
SOURCE = "program_counter"
READS = "the program's akx.pack totals: samples over samples_padded"


def read(r):
    return program.share("akx.request", "akx.pack", "samples",
                         "samples_padded")
