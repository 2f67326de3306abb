"""The share of the conv stacks built for the port's hand-written residual
conv kernel that ran through it: of the program's `akx.stack` spans
inside the profiled calls whose record carries a `hand_kernel` count
(the residual, non-equivariant kernel-7 stacks at the widths the kernel
takes: `pcn_resblock`'s Pitch2Pitch stack), those where it is 1. It
reads 100% when the kernel's gate takes every such stack, and falls
where a stack built for the kernel went back to the library's convs.
The equivariant pitch-class stacks carry no count: the kernel is not
built for them.

None where the program records no such span (a program before that
count, or a model with no stack the kernel is built for)."""

from benchmark import program
from benchmark.yardstick import program_clock

LAYER = "conv stacks (models.blocks.ConvStack)"
UNIT = "%"
MOVES = "device_audio_min_per_s"
SOURCE = "program_counter"
READS = "hand_kernel on the akx.stack spans of the profiled calls"


def read(r):
    found = program.spans("akx.model")
    if found is None:
        return None
    calls = program_clock.calls(found)
    built = [s for s in found if s.name == "akx.stack"
             and "hand_kernel" in s.counts
             and any(c.start_ns <= s.start_ns and s.end_ns <= c.end_ns
                     for c in calls)]
    if not built:
        return None
    return 100.0 * sum(s.counts["hand_kernel"] == 1
                       for s in built) / len(built)
