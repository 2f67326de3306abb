"""The check's control, and the faults a training cell is held against,
on the card at the cell's own size: each seed runs as `run.py` runs it,
with a stand-in (`stand_in.py`) in the system's place, and the harness's
own check has to find it not correct.

    python3 -m benchmark.control --workload default.resident \
        --stand-in tf32 --seed 1 2 3

prints one JSON line per seed: `correct` and the numbers the check
compared, each beside its limit. It needs the card (TF32 exists only
there); `tests/test_bench_control.py` runs it on three seeds a cell.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from . import harness, precision
from .stand_in import STAND_INS

ROOT = Path(__file__).resolve().parent.parent
# a window long enough to serve and compare as many requests as a run's
# check does (the serving kinds check every one a stand-in serves)
SECONDS = 8.0


def control(root, workload: str, seed: int, stand_in: str = "tf32",
            seconds: float = SECONDS, device="cuda") -> dict:
    """One run of `workload` with `stand_in` in the system's place."""
    res = harness.run_cell(root, workload, seed, seconds, False, device,
                           stand_in=stand_in)
    return {"seed": seed, "stand_in": stand_in, "correct": res["correct"],
            "checks": res["checks"], "readings": res["readings"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--stand-in", default="tf32", choices=sorted(STAND_INS))
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=SECONDS)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("error: the control needs the card (TF32)", file=sys.stderr)
        return 1
    precision.ieee()
    for s in args.seed:
        print(json.dumps(control(ROOT, args.workload, s, args.stand_in,
                                 args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
