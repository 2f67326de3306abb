"""The dense conv stacks (`--denseblock`) as a share of their roofline:
the bounds (`yardstick/densestack.py`, at the padded shapes the stacks
are given) of the program's `akx.stack` spans that ran a dense block in
the profiled calls (their record carries `dense_layers`), over the
device time of the rows launched inside them.

Spans are placed as `stack_ms_per_audio_min` places them, early by up to
the microseconds between a call's last launch and its span's close. A
dense stack ends on its block's output concatenation, so that launch
can fall out of the placed span: the rows launched after it, up to the
concatenations it lacks, are taken back (`densestack.placed`).

None where the program records no such span, and where a span's counts
(`convs`, `dense_layers`, and `cat_bytes`, which the program counts from
the input's shape), its concatenation launches or the number of dense
spans a call differ from the stacks the bound assumes."""

from benchmark import program
from benchmark.yardstick import densestack, program_clock

LAYER = "conv stacks (models.blocks.ConvStack)"
UNIT = "%"
MOVES = "device_audio_min_per_s"
SOURCE = "device_trace"
READS = "the dense akx.stack spans' device rows in the profiled calls"


def read(r):
    found = program.spans("akx.model")
    if found is None or not r.geometry.get("cqts"):
        return None
    g = r.geometry["cqts"][0]
    shapes = densestack.stacks(r.model, B=g["B"], T=1 + g["L"] // g["hop"])
    dense = densestack.placed(r.profile, found, shapes)
    if not dense:
        return None
    bound_s = sum(densestack.stack_bound(want)["bound_s"]
                  for _, want, _ in dense)
    device_us = sum(program_clock.device_us(rows) for _, _, rows in dense)
    if device_us <= 0:
        return None
    return 100.0 * bound_s / (device_us / 1e6)
