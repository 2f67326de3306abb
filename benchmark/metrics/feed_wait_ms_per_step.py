"""The training feed's hold on the step: milliseconds a step's consumer
waits on `prefetch`'s queue (the program's `akx.feed_wait` spans), over
the profiled slice's steps."""

from benchmark import program

LAYER = "training feed (data.dataset.KeyDataset.batches, data.pipeline.prefetch)"
UNIT = "ms/step"
MOVES = "train_songs_per_s"
SOURCE = "program_span"
READS = "the program's akx.feed_wait spans in the profiled slice's steps"


def read(r):
    found = program.spans("akx.train_step")
    if found is None or r.calls <= 0:
        return None
    return 1e3 * program.seconds(found, "akx.feed_wait") / r.calls
