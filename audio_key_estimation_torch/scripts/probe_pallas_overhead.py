"""Launch and grid overhead on a CUDA card (the counterpart of the JAX
package's scripts/probe_pallas_overhead.py).

Times csrc/probe_launch.cu — grid_n blocks that write ones into
(grid_n, 8, 128) and never read their input — over a matrix of
(input bytes x grid_n). Three explanations of a flat cost separate:

  per launch      -> time flat in both axes
  per block       -> time grows with grid_n at fixed input
  per input byte  -> time grows with the untouched input (it must not)

plus rows that read the launch floor, each with grid 1: two launches
from one C call (the counterpart of the TPU's two kernels in one
program), two Python calls, and 100 back-to-back launches from one C call
and from 100 Python calls, each divided by 100 (the card's own launch
interval, and the port's per-call floor through its ctypes wrapper).
Times are CUDA events around the launches: a warm-up, then the median of
AKX_REPS runs. Where the host cannot keep ahead of the card, the event
interval is the host's time.

Run on the card:  python -m audio_key_estimation_torch.scripts.probe_pallas_overhead
"""

from __future__ import annotations

import os

import torch

from audio_key_estimation_torch.ops import probes_cuda as PC
from audio_key_estimation_torch.scripts.harness import (card_line, log,
                                                        require_cuda, time_ms)

REPS = int(os.environ.get("AKX_REPS", 4))
SIZES = (("0.01 GB", 1 << 12), ("1.35 GB", 1_323_008),
         ("5.42 GB", 5_292_032))
GRIDS = (1, 25, 201)
BURST = 100


def main(sizes=SIZES, grids=GRIDS, reps: int = REPS) -> dict:
    """{(input label, grid_n) or a floor row's name: ms}."""
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
    rows["two launches, one call"] = time_ms(
        lambda: PC.launch_probe(x, 1, repeats=2), reps)
    rows["two launches, two calls"] = time_ms(
        lambda: (PC.launch_probe(x, 1), PC.launch_probe(x, 1)), reps)
    rows["burst, one call"] = time_ms(
        lambda: PC.launch_probe(x, 1, repeats=BURST), reps) / BURST

    def burst():
        for _ in range(BURST):
            PC.launch_probe(x, 1)
    rows["burst, Python calls"] = time_ms(burst, reps) / BURST
    for k in ("two launches, one call", "two launches, two calls"):
        log(f"  {k:26s}: {rows[k]:9.5f} ms")
    for k in ("burst, one call", "burst, Python calls"):
        log(f"  {BURST} launches, {k[7:]:14s}: {rows[k]:9.5f} ms per launch")
    return rows


if __name__ == "__main__":
    main()
