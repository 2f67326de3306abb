"""The residual conv stacks (`--resblock`) as a share of their roofline:
the bounds (`yardstick/resstack.py`, at the padded shapes the stacks are
given) of the program's `akx.stack` spans that ran residual blocks in
the profiled calls, over the device time of the rows launched inside
them (placed as `stack_ms_per_audio_min` places them).

None where the program records no such span, and where a span's counts
(`convs`, `res_blocks`) or the number of residual spans a call differ
from the stacks the bound assumes."""

from benchmark import program
from benchmark.yardstick import program_clock, resstack

LAYER = "conv stacks (models.blocks.ConvStack)"
UNIT = "%"
MOVES = "device_audio_min_per_s"
SOURCE = "device_trace"
READS = "the residual akx.stack spans' device rows in the profiled calls"


def read(r):
    found = program.spans("akx.model")
    if found is None or not r.geometry.get("cqts"):
        return None
    g = r.geometry["cqts"][0]
    shapes = resstack.stacks(r.model, B=g["B"], T=1 + g["L"] // g["hop"])
    calls = program_clock.calls(found)
    stacks = program_clock.placed(r.profile, found, "akx.stack")
    if not shapes or not calls or not stacks:
        return None
    res = [(s, rows) for s, rows in stacks if s.counts.get("res_blocks")]
    if len(res) != len(calls) * len(shapes):
        return None
    bound_s = device_us = 0.0
    for i, (s, rows) in enumerate(res):
        want = shapes[i % len(shapes)]
        if (s.counts.get("convs"), s.counts.get("res_blocks")) != (
                resstack.convs(want), want["blocks"]):
            return None
        bound_s += resstack.stack_bound(want)["bound_s"]
        device_us += program_clock.device_us(rows)
    if device_us <= 0:
        return None
    return 100.0 * bound_s / (device_us / 1e6)
