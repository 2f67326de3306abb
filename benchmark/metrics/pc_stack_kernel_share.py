"""The share of the pitch-class stacks built for the port's hand-written
pitch-class conv kernel (`csrc/pcconv.cu`) that ran through it: of the
program's `akx.stack` spans inside the profiled calls whose record
carries a `pc_kernel` count (the equivariant kernel-7 stacks, plain or
residual, at the widths the kernel takes: every pitch-class stack of
`pcn_default`, `pcn_multi_scale` and `pcn_resblock`), those where it is
1. It reads 100% when every such stack took the kernel, and falls where
one went back to the library's convs.

None where the program records no such span (a program before that
count, or a model with no stack the kernel is built for)."""

from benchmark import program
from benchmark.yardstick import program_clock

LAYER = "conv stacks (models.blocks.ConvStack)"
UNIT = "%"
MOVES = "device_audio_min_per_s"
SOURCE = "program_counter"
READS = "pc_kernel on the akx.stack spans of the profiled calls"


def read(r):
    found = program.spans("akx.model")
    if found is None:
        return None
    calls = program_clock.calls(found)
    built = [s for s in found if s.name == "akx.stack"
             and "pc_kernel" in s.counts
             and any(c.start_ns <= s.start_ns and s.end_ns <= c.end_ns
                     for c in calls)]
    if not built:
        return None
    return 100.0 * sum(s.counts["pc_kernel"] == 1
                       for s in built) / len(built)
