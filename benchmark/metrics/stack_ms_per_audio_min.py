"""The conv stacks' device time a useful audio-minute: the device rows
launched inside the program's `akx.stack` spans (every
`models.blocks.ConvStack` forward: kernel C's fused stack, a plain, a
residual or a dense one) in the profiled calls, over those calls'
audio-minutes.

Each span is placed on the profiler's clock by the offset the calls'
`bench.model` ranges and `akx.model` spans bound
(`yardstick/program_clock.py`): early by at most the microseconds
between a call's last launch and its `akx.model` span's close, the least
over the calls, so that a launch that late in a stack is left out. None
where the program records no `akx.stack` span (a commit before it, or
the reference in the system's place)."""

from benchmark import program
from benchmark.yardstick import program_clock

LAYER = "conv stacks (models.blocks.ConvStack)"
UNIT = "ms/audio-min"
MOVES = "device_audio_min_per_s"
SOURCE = "device_trace"
READS = "device rows launched in the program's akx.stack spans of the profiled calls"


def read(r):
    found = program.spans("akx.model")
    if found is None or r.call_minutes <= 0:
        return None
    stacks = program_clock.placed(r.profile, found, "akx.stack")
    if not stacks:
        return None
    us = sum(program_clock.device_us(rows) for _, rows in stacks)
    if us <= 0:
        return None
    return us / 1e3 / r.call_minutes
