"""The share of the dense conv stacks' device time spent in the blocks'
concatenation copies: of the device rows launched inside the program's
`akx.stack` spans that ran a dense block in the profiled calls (placed
and completed as `dense_stack_roofline` takes them), the time of the
rows that copy for the block's concatenations
(`densestack.block_concatenations`): the device-to-device copy torch
makes of a concatenation of one tensor (the input of a block's first
layer), and the launches of torch's concatenation kernel
(`CatArrayBatchedCopy`, matched from the start of the row's name)
before each later layer and for the block's output. A pitch-class
conv's wrap of its input over the pitch classes, which launches the
same kernel before each conv, is left out: it is the conv's padding,
not the block's. Lower is better: a block that wrote each layer's
features into its output in place would copy nothing.

None where the program records no such span, and where the spans'
counts (`convs`, `dense_layers`, `cat_bytes`), their concatenation
launches or their number differ from the stacks the yardstick
assumes."""

from benchmark import program
from benchmark.yardstick import densestack, program_clock

LAYER = "conv stacks (models.blocks.ConvStack)"
UNIT = "%"
MOVES = "device_audio_min_per_s"
SOURCE = "device_trace"
READS = "the dense akx.stack spans' block concatenation rows"


def read(r):
    found = program.spans("akx.model")
    if found is None or not r.geometry.get("cqts"):
        return None
    g = r.geometry["cqts"][0]
    shapes = densestack.stacks(r.model, B=g["B"], T=1 + g["L"] // g["hop"])
    dense = densestack.placed(r.profile, found, shapes)
    if not dense:
        return None
    device_us = cat_us = 0.0
    for _, want, rows in dense:
        device_us += program_clock.device_us(rows)
        cat_us += program_clock.device_us(
            densestack.block_concatenations(want, rows))
    if device_us <= 0:
        return None
    return 100.0 * cat_us / device_us
