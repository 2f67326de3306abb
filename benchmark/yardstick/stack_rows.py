"""The program's conv stacks of one kind in a profiled slice: the
`akx.stack` spans whose record carries a given count, placed on the
profiler's clock with the device rows launched in them
(`program_clock.placed`), and each stack's last launches, which that
placement can leave out, taken back from after it.

A stack kind gives the rows to count (`counts`, a predicate on a row)
and how many of them a stack of a geometry launches (`want`); a stack
that holds fewer is completed with the rows launched after its last
one, and a stack that holds more is not the stack the geometry
describes."""

from __future__ import annotations

from . import program_clock


def completed(profile, rows, want: int, counts) -> list | None:
    """rows with a stack's missing last launches taken from after them:
    every row launched after its last one, up to the `want`-th row that
    `counts` takes; None where there are not enough, or where rows hold
    more than `want` already."""
    have = sum(map(counts, rows))
    last = max((r.launch_us for r in rows), default=float("-inf"))
    later = iter(sorted((r for r in profile.rows if r.launch_us > last),
                        key=lambda r: r.launch_us))
    while have < want:
        r = next(later, None)
        if r is None:
            return None
        rows = rows + [r]
        have += counts(r)
    return rows if have == want else None


def placed(profile, found: list, shapes: list, kind: str, fits, want,
           counts) -> list | None:
    """[(span, geometry, rows)] of each `akx.stack` span whose record
    carries the count `kind` in the profiled calls, in the order they
    ran, paired in turn with `shapes` (one call's stacks of that kind),
    with the device rows launched in it, completed (`completed`) to
    `want(geometry)` rows that `counts` takes; None where there are
    none, where a call's such spans are more or fewer than `shapes`, or
    where a span's record does not fit its geometry (`fits(span,
    geometry)` false)."""
    calls = program_clock.calls(found)
    stacks = program_clock.placed(profile, found, "akx.stack")
    if not shapes or not calls or not stacks:
        return None
    mine = [(s, rows) for s, rows in stacks if kind in s.counts]
    if len(mine) != len(calls) * len(shapes):
        return None
    out = []
    for i, (s, rows) in enumerate(mine):
        g = shapes[i % len(shapes)]
        if not fits(s, g):
            return None
        rows = completed(profile, rows, want(g), counts)
        if rows is None:
            return None
        out.append((s, g, rows))
    return out
