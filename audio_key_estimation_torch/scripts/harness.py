"""What every entry point on the card shares: CUDA-event timing (one
eager call, or replays of a CUDA graph), the card line, and the refusal
to run without a card."""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def require_cuda(what: str) -> torch.device:
    """The CUDA device, or SystemExit: no probe measures a CPU."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{what}: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    return torch.device("cuda")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of fn over `reps` runs after `warmup` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def graph_ms(fn, reps: int = 20, repeat: int = 5) -> float:
    """The card's time of one call of fn: fn captured `repeat` times into
    one CUDA graph, the replay timed (time_ms) and divided by `repeat`.
    The host's time between launches is not counted, and the graph's own
    launch (a few µs before the card sees the first kernel) is spread
    over `repeat` calls; each launch inside the graph still costs its
    own ~1 µs. fn must give the same result when run again."""
    fn()                                  # outside the capture: warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(repeat):
            fn()
    return time_ms(graph.replay, reps) / repeat
