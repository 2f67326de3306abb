"""Launch and grid overhead on a CUDA card (the counterpart of the JAX
package's scripts/probe_pallas_overhead.py).

Times csrc/probe_launch.cu — grid_n blocks that write ones into
(grid_n, 8, 128) and never read their input — over a matrix of
(input bytes x grid_n). Three explanations of a flat cost separate:

  per launch      -> time flat in both axes
  per block       -> time grows with grid_n at fixed input
  per input byte  -> time grows with the untouched input (it must not)

plus rows that read the launch floor, each with grid 1: two launches
from one operator call and from two wrapper calls; 100 back-to-back
launches from one operator call and from 100 wrapper calls (the port's
per-call floor: the Python wrapper, the dispatcher, the allocator and
the launch), each divided by 100; and 100 wrapper calls captured into one
torch.cuda.CUDAGraph and replayed, divided by 100, at grid 1 and at grid
201 (the card's own launch interval with no host in between: the
counterpart of the TPU's two kernels in one program). Times are CUDA
events around the launches: a warm-up, then the median of AKX_REPS runs.
Where the host cannot keep ahead of the card, the event interval is the
host's time.

Then the host's cost per call, all rows in one process and interleaved
(the median of HOST_ROUNDS rounds; a row of a round is the mean of
HOST_CALLS calls on the host clock, ending in a synchronize): the
wrapper, its operator torch.ops.akt.launch_probe called directly,
torch.ones and torch.empty of the same output, the two Python objects a
wrapper could build per call to reach the current stream and device
(torch.cuda.current_stream(device).cuda_stream and a torch.cuda.device
context), and the kernel's C launcher akt_launch_probe called through
ctypes after a torch.empty, once with the raw current-stream handle and
once inside both of those objects (the binding the operators replaced).

Run on the card:  python -m audio_key_estimation_torch.scripts.probe_pallas_overhead
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from audio_key_estimation_torch.ops import _build
from audio_key_estimation_torch.ops import probes_cuda as PC
from audio_key_estimation_torch.scripts.harness import (card_line, log,
                                                        require_cuda, time_ms)

REPS = int(os.environ.get("AKX_REPS", 4))
SIZES = (("0.01 GB", 1 << 12), ("1.35 GB", 1_323_008),
         ("5.42 GB", 5_292_032))
GRIDS = (1, 25, 201)
BURST = 100
HOST_ROUNDS = 5
HOST_CALLS = 2000


def host_us(fn, calls: int) -> float:
    """Mean host microseconds per call of fn over `calls` calls, ending in
    a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def _c_launcher():
    """akt_launch_probe, the C launcher behind the operator, as a ctypes
    function of the loaded kernel library (a return code, not an
    exception, reports a failed launch)."""
    import ctypes
    fn = ctypes.CDLL(str(_build.library_path())).akt_launch_probe
    fn.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p)
    fn.restype = ctypes.c_int
    return fn


def host_rows(x: torch.Tensor, rounds: int = HOST_ROUNDS,
              calls: int = HOST_CALLS) -> dict:
    """{row: host µs per call}, the median over `rounds` interleaved
    rounds after one warm-up round, every row at grid 1 on x's device."""
    op = _build.op("launch_probe")
    dev = x.device

    def device_context():
        with torch.cuda.device(dev):
            pass
    launcher = _c_launcher()
    index = dev.index if dev.index is not None else 0

    def ctypes_raw_stream():
        out = torch.empty(1, 8, 128, device=dev)
        if launcher(x.data_ptr(), out.data_ptr(), 1, 1,
                    torch._C._cuda_getCurrentRawStream(index)):
            raise RuntimeError("akt_launch_probe failed")

    def ctypes_stream_object():
        with torch.cuda.device(dev):
            out = torch.empty(1, 8, 128, device=dev)
            if launcher(x.data_ptr(), out.data_ptr(), 1, 1,
                        torch.cuda.current_stream(dev).cuda_stream):
                raise RuntimeError("akt_launch_probe failed")
    # rows that launch the kernel outside its wrapper, counted below
    direct = {"operator akt::launch_probe": lambda: op(x, 1, 1),
              "ctypes launcher, raw stream": ctypes_raw_stream,
              "ctypes launcher, Stream + device context":
                  ctypes_stream_object}
    fns = {
        "wrapper launch_probe(x, 1)": lambda: PC.launch_probe(x, 1),
        **direct,
        "torch.ones(1, 8, 128)": lambda: torch.ones(1, 8, 128, device=dev),
        "torch.empty(1, 8, 128)": lambda: torch.empty(1, 8, 128,
                                                      device=dev),
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "torch.cuda.device(dev) context": device_context,
    }
    times = {k: [] for k in fns}
    for _ in range(rounds + 1):               # the first round warms up
        for k, fn in fns.items():
            times[k].append(host_us(fn, calls))
        PC.launch_probe.launches += calls * len(direct)
    return {k: float(np.median(v[1:])) for k, v in times.items()}


def main(sizes=SIZES, grids=GRIDS, reps: int = REPS) -> dict:
    """{(input label, grid_n) or a floor row's name: ms; "host, <row>":
    µs per call}."""
    device = require_cuda("probe_pallas_overhead")
    log(f"launch overhead probe on {torch.cuda.get_device_name(0)} "
        f"({card_line()})")
    rows = {}
    for gb, n_rows in sizes:
        x = torch.zeros((n_rows, 512), dtype=torch.int16, device=device)
        for grid_n in grids:
            ms = time_ms(lambda: PC.launch_probe(x, grid_n), reps)
            rows[(gb, grid_n)] = ms
            log(f"  input {gb:8s} grid={grid_n:4d}: {ms:9.5f} ms")
        del x
    x = torch.zeros((sizes[0][1], 512), dtype=torch.int16, device=device)
    rows["two launches, one op call"] = time_ms(
        lambda: PC.launch_probe(x, 1, repeats=2), reps)
    rows["two launches, two wrapper calls"] = time_ms(
        lambda: (PC.launch_probe(x, 1), PC.launch_probe(x, 1)), reps)
    rows["burst, one op call"] = time_ms(
        lambda: PC.launch_probe(x, 1, repeats=BURST), reps) / BURST

    def burst():
        for _ in range(BURST):
            PC.launch_probe(x, 1)
    rows["burst, wrapper calls"] = time_ms(burst, reps) / BURST
    for grid_n in (1, 201):
        replay, _ = PC.launch_graph(x, grid_n, BURST)
        rows[f"burst, graph replay, grid {grid_n}"] = time_ms(
            replay, reps) / BURST
        del replay
    for k in ("two launches, one op call", "two launches, two wrapper calls"):
        log(f"  {k:31s}: {rows[k]:9.5f} ms")
    for k in rows:
        if isinstance(k, str) and k.startswith("burst"):
            log(f"  {BURST} launches, {k[7:]:24s}: {rows[k]:9.5f} ms per "
                "launch")
    host = host_rows(x)
    for k, us in host.items():
        log(f"  host per call, {k:42s}: {us:8.3f} us")
        rows[f"host, {k}"] = us
    return rows


if __name__ == "__main__":
    main()
