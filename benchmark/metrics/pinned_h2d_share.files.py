"""The share of the bytes the program copies to the card for its served
batches (`KeyEstimator.make_batch`) that went through its page-locked
staging buffer: the `akx.h2d` counter's pinned_bytes over its bytes,
over every request the process served. A program that counts no
page-locked bytes gives nothing."""

from audio_key_estimation_torch.utils import profiling
from benchmark import program

LAYER = "batch + H2D (predict.KeyEstimator.make_batch)"
UNIT = "%"
MOVES = "served_audio_min_per_s"
SOURCE = "program_counter"
READS = "the program's akx.h2d totals: pinned_bytes over bytes"


def read(r):
    if "pinned_bytes" not in profiling.totals().get("akx.h2d", {}):
        return None
    return program.share("akx.request", "akx.h2d", "pinned_bytes", "bytes")
