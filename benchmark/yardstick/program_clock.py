"""The program's own spans placed on the profiler's clock, and the device
rows launched inside them.

The program stamps a span (`audio_key_estimation_torch.utils.profiling`)
with `time.perf_counter_ns`; the profiled slice's rows and the
benchmark's `bench.*` ranges carry the profiler's clock, counted from its
trace's start. The two clocks run at one rate and differ by an offset.
Each call of the slice has one `bench.model` range and, opened inside
it, one `akx.model` span (`est.model` is the model's forward), and
nothing launches inside the range but outside the span, so each call
bounds the offset from below twice:

  * the range's start less the span's start (the range opens first);
  * its last launch inside the range less the span's end (the launch
    comes before the span closes).

The largest of these bounds over the slice's calls is taken. It places
the spans early by the least time, over the calls, between a call's last
launch (the heads' sigmoid) and the close of its `akx.model` span: 11 to
23 us on the H100's host in the resident cells. So a launch that comes
later than that before its span closes is left out, and one that comes
that little before it opens is counted. Held against the profiler's own
ranges of the program's spans (NVIDIA H100 80GB HBM3, 700 W), the first
left out the last elementwise row of most stacks, and in some calls the
last conv7_kernel row of kernel C's stack: 0.16% of the residual stacks'
device time, 0 to 3.3% of the default model's stacks'; the second never
happened.
"""

from __future__ import annotations

CALL_RANGE = "bench.model"
CALL_SPAN = "akx.model"


def calls(found: list) -> list:
    return sorted((s for s in found if s.name == CALL_SPAN),
                  key=lambda s: s.start_ns)


def offset(profile, found: list) -> float | None:
    """The profiler's clock less the program's, in us, as the profiled
    calls bound it; None where the calls' ranges and spans do not pair
    one to one."""
    ranges = sorted((s, e) for n, s, e in profile.ranges if n == CALL_RANGE)
    spans = calls(found)
    if not ranges or len(ranges) != len(spans):
        return None
    bounds = []
    for (rs, re), span in zip(ranges, spans):
        bounds.append(rs - span.start_ns / 1e3)
        launched = [r.launch_us for r in profile.rows
                    if rs <= r.launch_us <= re]
        if launched:
            bounds.append(max(launched) - span.end_ns / 1e3)
    return max(bounds)


def placed(profile, found: list, name: str) -> list | None:
    """[(span, rows)] of each span named `name` inside a profiled call, in
    the order they started, with the device rows launched while it was
    open; None where the calls cannot be placed."""
    at = offset(profile, found)
    if at is None:
        return None
    spans = calls(found)
    out = []
    for s in sorted((s for s in found if s.name == name),
                    key=lambda s: s.start_ns):
        if not any(c.start_ns <= s.start_ns and s.end_ns <= c.end_ns
                   for c in spans):
            continue
        lo, hi = s.start_ns / 1e3 + at, s.end_ns / 1e3 + at
        out.append((s, [r for r in profile.rows if lo <= r.launch_us <= hi]))
    return out


def device_us(rows) -> float:
    return sum(r.end_us - r.start_us for r in rows)
