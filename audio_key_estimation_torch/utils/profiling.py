"""The port's tracer: spans at its layer boundaries, counters of the work
done there, and `trace(log_dir)`, the operator's Chrome-trace exporter.

`span(name, request=None, tally=True, **counts)` is a context manager:

  * `counts` (work known before it starts: samples, bytes, frames) are
    added to process-wide totals on every call, traced or not;
    `totals()` returns them, so useful-against-padded shares can be read
    without a profiler. Only the spans whose counts a metric reads take
    any (PERF.md §3). With `tally` False the counts go on the span's
    record alone (a ConvStack's convs and blocks, which describe the
    work rather than add to a total), and off the profiler the span
    stays one flag check.
  * While a torch.profiler session is active (the profiler's own enabled
    flag; nothing else turns tracing on), the span is recorded, with
    its name, start and end (`time.perf_counter_ns`), the enclosing span
    on the same thread and the request id it inherits from it, and it
    opens a profiler range of its name. The range is a plain CPU op, not
    a user annotation, so the profiler mirrors no row of it onto the
    device's timeline, and it lies on one clock with the kernels and
    copies in the profiler's trace.
  * `request` starts a request where no span is open on the thread: True
    for the next id of a process-wide counter, or an id of the caller's
    (a training step). A span directly inside one of the same name (an
    ensemble's tower inside the ensemble's forward) records nothing more.
  * Off the profiler the span is one flag check and a shared null
    context: no clock read, no range, no record.

`spans()` returns the records of the newest profiler session only.
PERF.md §3 names each `akx.*` span and counter with what reads it.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


class Span(NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]      # the enclosing span's id, same thread
    request: Optional[int]
    counts: dict


_OFF = contextlib.nullcontext()
_ids = itertools.count()
_requests = itertools.count()
_local = threading.local()
_lock = threading.Lock()
_totals: dict = {}
_session: list = []            # the newest profiler session's records


def _add(name: str, counts: dict) -> None:
    with _lock:
        t = _totals.get(name)
        if t is None:
            t = _totals[name] = {}
        for k, v in counts.items():
            t[k] = t.get(k, 0) + int(v)


def totals() -> dict:
    """{span name: {count: total}} over the process's life."""
    with _lock:
        return {k: dict(v) for k, v in _totals.items()}


def spans() -> list:
    """The records (Span) of the newest profiler session, in the order
    they ended."""
    return list(_session)


def span(name: str, request=None, tally: bool = True, **counts):
    """A context manager around one layer's work; see the module's
    docstring."""
    if counts and tally:
        _add(name, counts)
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    if stack and stack[-1].name == name:
        return _OFF
    return _Open(name, request, counts, stack)


class _Open:
    __slots__ = ("name", "request", "counts", "stack", "id", "parent",
                 "records", "range", "start")

    def __init__(self, name, request, counts, stack):
        self.name, self.counts, self.stack = name, counts, stack
        top = stack[-1] if stack else None
        self.parent = None if top is None else top.id
        if top is not None:
            self.request = top.request
        else:
            self.request = next(_requests) if request is True else request

    def __enter__(self):
        self.id = next(_ids)
        self.records = _session
        self.range = torch._C._profiler._RecordFunctionFast(self.name)
        self.range.__enter__()
        self.stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.stack.pop()
        self.range.__exit__(*exc)
        self.records.append(Span(self.id, self.name, self.start, end,
                                 self.parent, self.request, self.counts))
        return False


def _watch_sessions() -> None:
    """Start a new list of records whenever a profiler session starts:
    torch's profilers all call `_run_on_profiler_start` as they start."""
    start = _autograd_profiler._run_on_profiler_start

    def run():
        global _session
        _session = []
        start()

    _autograd_profiler._run_on_profiler_start = run


_watch_sessions()


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the CPU and (when present) CUDA activities;
    writes the Chrome trace to log_dir/trace.json (chrome://tracing,
    Perfetto), where the program's `akx.*` spans lie on one timeline
    with the kernels and copies they launched (PERF.md §3 lists them).
    Yields the profiler."""
    act = torch.profiler.ProfilerActivity
    activities = [act.CPU] + ([act.CUDA] if torch.cuda.is_available()
                              else [])
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
