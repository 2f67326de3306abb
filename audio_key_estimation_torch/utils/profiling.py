"""Throughput counters + torch.profiler hooks.

The port of the JAX package's utils/profiling.py (there on jax.profiler):
a step timer that reports audio-minutes/sec and per card, and
`trace(log_dir)`, which records the host and the CUDA device with
torch.profiler and writes a Chrome trace under log_dir.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import List

import torch

from ..parallel.mesh import data_world


@dataclass
class ThroughputMeter:
    """Accumulates wall time and audio seconds processed."""
    audio_seconds: float = 0.0
    wall_seconds: float = 0.0
    _t0: float = 0.0
    samples: List[float] = field(default_factory=list)

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, audio_seconds: float):
        dt = time.perf_counter() - self._t0
        self.wall_seconds += dt
        self.audio_seconds += audio_seconds
        self.samples.append(audio_seconds / dt if dt > 0 else 0.0)

    @property
    def audio_min_per_sec(self) -> float:
        if self.wall_seconds == 0:
            return 0.0
        return (self.audio_seconds / 60.0) / self.wall_seconds

    def per_chip(self, n_chips: int = None) -> float:
        """audio_min_per_sec over n_chips cards (default: the process
        group's world size, else the visible CUDA devices)."""
        n = n_chips
        if not n:
            world = data_world()[1]
            n = world if world > 1 else torch.cuda.device_count()
        return self.audio_min_per_sec / max(n, 1)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the CPU and (when present) CUDA activities;
    writes the Chrome trace to log_dir/trace.json (chrome://tracing,
    Perfetto). Yields the profiler."""
    act = torch.profiler.ProfilerActivity
    activities = [act.CPU] + ([act.CUDA] if torch.cuda.is_available()
                              else [])
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
