"""Run one cell of the benchmark once, on the card, and print its result.

    python3 -m benchmark.run --workload default.resident --seed 7 \
        --seconds 30 --trace 0

Each run is its own process: set-up (imports, CUDA, the kernels'
library, the cell's inputs, the weights, the warm-up of the cell's own
shapes), then the measured window of `--seconds`, then, with
`--trace 1`, a profiled slice whose readings give the per-layer
metrics, then the check against the plain reference. The last line of
standard output is one JSON object: correct, attempted, failed,
metrics, device, (breakdown,) and last the numbers the check compared,
each beside its limit; they are also the last lines on standard error.

Without a CUDA device (or with fewer than the cell asks for) it exits
with an error and prints no result. It never runs on the CPU.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# packages the port, or a library it loads, must not bring in
FORBIDDEN = ("jax", "jaxlib", "flax", "audio_key_estimation_tpu")
os.environ.setdefault("USE_FLAX", "0")


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def number(v):
    """A JSON number, or a string for inf and nan."""
    return v if math.isfinite(v) else str(v)


def main(argv=None) -> int:
    args = parse_args(argv)
    from benchmark import harness
    try:
        ctx = harness.context(ROOT, args.workload, args.seed, "cpu")
    except harness.CellError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    import torch
    need = int(ctx.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"error: {args.workload} needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " (the benchmark never runs on the CPU)", file=sys.stderr)
        return 1
    from benchmark import precision
    precision.ieee()
    res = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", started=STARTED)
    found = forbidden_modules()
    if found:
        print(f"error: the run loaded {found}: the benchmark measures the "
              "PyTorch port alone", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": need, "memory_peak_bytes": int(res["peak"]),
              "power_limit": power_limit()}
    if args.trace:
        device["busy_s"] = res["busy_s"]
        device["window_s"] = res["window_s"]
    out = {"correct": bool(res["correct"]), "attempted": res["attempted"],
           "failed": res["failed"], "metrics": res["metrics"],
           "device": device}
    if args.trace:
        out["breakdown"] = res["breakdown"]
    out["checks"] = {k: {"value": number(c["value"]),
                         "limit": number(c["limit"])}
                     for k, c in res["checks"].items()}
    for k, v in res["readings"].items():
        print(f"reading {k}: {v!r} (not compared)", file=sys.stderr)
    for k, c in res["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
