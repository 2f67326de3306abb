"""Reading the device's work from torch.profiler.

`profiled` is a copy of the port's chip check of the same name
(`chip_smoke.py::profiled`): on this card torch's profiler drops the
device rows of a session's first launches, so 1024 one-element kernels
run first inside the profile and their rows are left out; what is left
is the device rows of `fn`'s own launches. It returns them as plain
tuples, with the host ranges the benchmark opened (names beginning with
`bench.`), so that readers need no profiler object.

A device row is (name, start_us, end_us, launch_us): the kernel or copy
on the device and the host time of the launch that queued it. Every time
is on the profiler's one clock.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import torch

PAD_LAUNCHES = 1024
RANGE_PREFIX = "bench."


class Row(NamedTuple):
    name: str
    start_us: float
    end_us: float
    launch_us: float


class Profile(NamedTuple):
    rows: list            # Row, fn's device rows only
    ranges: list          # (name, start_us, end_us) host ranges of bench.*
    window_s: float       # host wall of fn, from a synchronize to one


def _is_launch(name: str) -> bool:
    return "LaunchKernel" in name or "Memcpy" in name or "Memset" in name


def profiled(fn: Callable[[], None], device) -> Profile:
    """fn() once under torch.profiler, after PAD_LAUNCHES one-element
    kernels; on a CPU device, fn() under a CPU-only profile (no rows)."""
    act = torch.profiler.ProfilerActivity
    cuda = torch.device(device).type == "cuda"
    activities = [act.CPU, act.CUDA] if cuda else [act.CPU]
    pad = torch.zeros(1, device=device)
    with torch.profiler.profile(activities=activities) as prof:
        if cuda:
            for _ in range(PAD_LAUNCHES):
                pad.add_(1.0)
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        window = time.perf_counter() - t0
    dev = torch.autograd.DeviceType.CUDA
    events = prof.events()
    host = [e for e in events if e.device_type != dev]
    launches = sorted((e for e in host if _is_launch(e.name)),
                      key=lambda e: e.time_range.start)
    kernel_launches = [e for e in launches if "LaunchKernel" in e.name]
    pads = {e.id for e in kernel_launches[:PAD_LAUNCHES]} if cuda else set()
    launch_at = {e.id: e.time_range.start for e in launches
                 if e.id not in pads}
    rows = []
    for e in events:
        if e.device_type != dev or e.name.startswith(RANGE_PREFIX):
            continue
        if e.id in launch_at:
            rows.append(Row(e.name, e.time_range.start, e.time_range.end,
                            launch_at[e.id]))
    ranges = sorted((e.name, e.time_range.start, e.time_range.end)
                    for e in host if e.name.startswith(RANGE_PREFIX))
    return Profile(sorted(rows, key=lambda r: r.start_us), ranges, window)


def busy_us(rows) -> float:
    """Microseconds in which at least one of the rows ran on the device."""
    total, end = 0.0, float("-inf")
    for r in sorted(rows, key=lambda r: r.start_us):
        if r.end_us > end:
            total += r.end_us - max(r.start_us, end)
            end = r.end_us
    return total


def rows_in(profile: Profile, range_name: str) -> list:
    """The device rows launched while a host range of that name was open."""
    spans = [(s, e) for n, s, e in profile.ranges if n == range_name]
    return [r for r in profile.rows
            if any(s <= r.launch_us <= e for s, e in spans)]


def idle_gaps(profile: Profile, top: int = 10) -> list:
    """The longest gaps between device rows, each named by the innermost
    benchmark range the host had open at the gap's midpoint ("host" when
    none), as [name, seconds]."""
    gaps, end = [], None
    for r in sorted(profile.rows, key=lambda r: r.start_us):
        if end is not None and r.start_us > end:
            gaps.append((end, r.start_us))
        end = r.end_us if end is None else max(end, r.end_us)
    named = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (s + e) / 2
        open_ = [(rs, n) for n, rs, re in profile.ranges if rs <= mid <= re]
        named.append([max(open_)[1] if open_ else "host", (e - s) / 1e6])
    return named


def device_ops(profile: Profile, top: int = 10) -> list:
    """The device operations that took most time, as [name, seconds]."""
    by = {}
    for r in profile.rows:
        by[r.name] = by.get(r.name, 0.0) + (r.end_us - r.start_us) / 1e6
    return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
