"""The useful share of the frames the training steps run through the
model: the `akx.pad` counter's songs' frames over rows x the bucket's
frames (`KeyDataset.batches`), over every batch the process padded. The
feed pads on `prefetch`'s thread ahead of the steps, so the process's
totals are read, not the slice's."""

from benchmark import program

LAYER = "training feed (data.dataset.KeyDataset.batches, data.pipeline.prefetch)"
UNIT = "%"
MOVES = "train_songs_per_s"
SOURCE = "program_counter"
READS = "the program's akx.pad totals: frames over frames_padded"


def read(r):
    return program.share("akx.train_step", "akx.pad", "frames",
                         "frames_padded")
