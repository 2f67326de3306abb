"""The program's own spans and counters
(`audio_key_estimation_torch.utils.profiling`: `spans()`, the newest
profiler session's records; `totals()`, the process's counts).

A profiled slice in which the program's root span never ran (the
reference in its place), or a program older than its tracer (a commit
before it, which the benchmark's readers also run over), gives nothing
to read: the readers then return None and the metric is left out of the
line.
"""

from __future__ import annotations

from audio_key_estimation_torch.utils import profiling


def spans(root: str) -> list | None:
    """The profiled slice's spans, or None where no span named `root`
    (the program's request or step) ran in it."""
    read = getattr(profiling, "spans", None)
    found = read() if read is not None else []
    if not any(s.name == root for s in found):
        return None
    return found


def seconds(found: list, name: str) -> float:
    """The summed duration of the spans named `name`."""
    return sum(s.end_ns - s.start_ns for s in found if s.name == name) / 1e9


def share(root: str, name: str, useful: str, padded: str) -> float | None:
    """100 x the process's total `useful` count of span `name` over its
    `padded` count, where the profiled slice ran the program's `root`."""
    if spans(root) is None:
        return None
    counts = profiling.totals().get(name, {})
    if not counts.get(padded):
        return None
    return 100.0 * counts.get(useful, 0) / counts[padded]
