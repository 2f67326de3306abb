"""The pitch-class stacks as a share of their roofline: the bounds
(`yardstick/pcstack.py`, at the padded shapes the stacks are given) of
the program's `akx.stack` spans that carry a `pc_kernel` count in the
profiled calls, over the device time of the rows launched inside them.

Spans are placed as `stack_ms_per_audio_min` places them, early by up to
the microseconds between a call's last launch and its span's close. A
stack that ran the kernel ends on its last conv's launch, so that launch
can fall out of the placed span: where a span with `pc_kernel` 1 holds
fewer `pitch_class_conv_kernel` rows than it ran convs, the missing ones
are the next such rows launched after it.

None where the program records no such span, and where a span's counts
(`convs`, `res_blocks`), the number of such spans a call or the kernel's
rows differ from the stacks the bound assumes."""

from benchmark import program
from benchmark.yardstick import pcstack, program_clock

LAYER = "conv stacks (models.blocks.ConvStack)"
UNIT = "%"
MOVES = "device_audio_min_per_s"
SOURCE = "device_trace"
READS = "the pc_kernel akx.stack spans' device rows in the profiled calls"
KERNEL_ROW = "pitch_class_conv_kernel"


def _completed(profile, rows, convs: int) -> list | None:
    """rows with the kernel's missing last launches taken from after them;
    None where there are not enough."""
    have = sum(KERNEL_ROW in r.name for r in rows)
    if have >= convs:
        return rows
    last = max((r.launch_us for r in rows), default=float("-inf"))
    later = sorted((r for r in profile.rows if r.launch_us > last
                    and KERNEL_ROW in r.name), key=lambda r: r.launch_us)
    if len(later) < convs - have:
        return None
    return rows + later[:convs - have]


def read(r):
    found = program.spans("akx.model")
    if found is None or not r.geometry.get("cqts"):
        return None
    g = r.geometry["cqts"][0]
    shapes = pcstack.stacks(r.model, B=g["B"], T=1 + g["L"] // g["hop"])
    calls = program_clock.calls(found)
    stacks = program_clock.placed(r.profile, found, "akx.stack")
    if not shapes or not calls or not stacks:
        return None
    pc = [(s, rows) for s, rows in stacks if "pc_kernel" in s.counts]
    if len(pc) != len(calls) * len(shapes):
        return None
    bound_s = device_us = 0.0
    for i, (s, rows) in enumerate(pc):
        want = shapes[i % len(shapes)]
        n = pcstack.convs(want)
        if (s.counts.get("convs"), s.counts.get("res_blocks")) != (
                n, want["blocks"]):
            return None
        if s.counts["pc_kernel"] == 1:
            rows = _completed(r.profile, rows, n)
            if rows is None:
                return None
        bound_s += pcstack.stack_bound(want)["bound_s"]
        device_us += program_clock.device_us(rows)
    if device_us <= 0:
        return None
    return 100.0 * bound_s / (device_us / 1e6)
