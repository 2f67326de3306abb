"""The generic driver: one cell, one seed, one run.

Everything that belongs to a cell is found by name, under the checkout
given as `root` (the benchmark's own folder in it):
  BENCHMARK.json               the cell (its configuration and traffic),
                               the metrics and which cells report them;
  configs/<config>.json        the configuration as it is run;
  reference/<reference>.py     the plain reference model the
                               configuration names (reference.of);
  mixes/<traffic>.json         the traffic mix: its kind and parameters;
  traffic/<kind>.py            the generator and window driver of a kind;
  metrics/<metric>.py          the reader of one per-layer metric;
  limits/<cell>.json           the limit of each number the check compares.

`run_cell` runs on any device so that the CPU tests can drive it at a
tiny size; `run.py` refuses to start without the card.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import time
from pathlib import Path

import numpy as np
import torch

from . import reference
from .reference import cqt as ref_cqt
from .reference import serve as ref_serve
from .traffic import synth

HERE = Path(__file__).resolve().parent
CALIBRATION_CLIPS = 4
CALIBRATION_SECONDS = 20


class CellError(ValueError):
    """A cell, configuration, mix or metric that cannot be found or read."""


def load_json(path: Path) -> dict:
    try:
        return json.loads(Path(path).read_text())
    except FileNotFoundError:
        raise CellError(f"{path}: no such file") from None


@dataclasses.dataclass
class Context:
    root: Path                 # the checkout: BENCHMARK.json and benchmark/
    bench: dict                # BENCHMARK.json
    cell: dict                 # its entry in "workloads"
    config: dict               # configs/<config>.json (names its reference)
    mix: dict                  # mixes/<traffic>.json
    limits: dict               # limits/<cell>.json
    seed: int
    device: torch.device
    stand_in: str | None = None   # stand_in.py's name, in the system's place

    @property
    def model(self) -> dict:
        """The configuration as the reference reads it."""
        m = dict(self.config["model"])
        m["reference"] = self.config["reference"]
        m["bins_per_octave"] = 12 if m.get("only_semitones") else 36
        m["cqt_stream_dtype"] = self.config["precision"]["cqt_streams"]
        m["stack_dtype"] = self.config["precision"]["p2p_stacks"]
        return m

    def program_config(self):
        """The system's Config: the model's fields and the runtime flags."""
        from audio_key_estimation_torch.config import Config
        return Config(**self.config["model"], **self.config["runtime"],
                      seed=0)

    def sub_seed(self, *keys: int) -> int:
        """A seed derived from the run's seed and `keys`."""
        return int(np.random.SeedSequence([self.seed, *keys])
                   .generate_state(1, np.uint64)[0] >> 1)


def context(root, workload: str, seed: int, device,
            stand_in: str | None = None) -> Context:
    root = Path(root)
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise CellError(f"unknown workload {workload!r}; BENCHMARK.json "
                        f"names {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    if cell["config"] not in configs:
        raise CellError(f"{workload}: unknown config {cell['config']!r}")
    config = load_json(root / configs[cell["config"]]["file"])
    try:
        reference.of(config)
    except LookupError as e:
        raise CellError(f"config {cell['config']!r}: {e}") from None
    home = root / HERE.name
    mix = load_json(home / "mixes" / f"{cell['traffic']}.json")
    limits = load_json(home / "limits" / f"{workload}.json")
    return Context(root, bench, cell, config, mix, limits, int(seed),
                   torch.device(device), stand_in)


def traffic_kind(ctx: Context):
    """The module of the mix's kind: traffic/<kind>.py."""
    kind = ctx.mix["kind"]
    if not (HERE / "traffic" / f"{kind}.py").exists():
        raise CellError(f"mix {ctx.cell['traffic']!r}: no traffic kind "
                        f"{kind!r} (benchmark/traffic/{kind}.py)")
    return importlib.import_module(f"{__package__}.traffic.{kind}")


def reader(ctx: Context, name: str):
    """The reader of a per-layer metric: metrics/<name>.py."""
    path = ctx.root / HERE.name / "metrics" / f"{name}.py"
    if not path.exists():
        raise CellError(f"metric {name!r}: no reader {path}")
    spec = importlib.util.spec_from_file_location(
        f"{__package__}.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(ctx: Context, group: str) -> list:
    """The metrics of `group` ("end_to_end" or "per_layer") this cell
    reports: those without a workloads list, and those that list it."""
    return [m for m in ctx.bench[group]
            if ctx.cell["name"] in m.get("workloads", [ctx.cell["name"]])]


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def weights(ctx: Context) -> dict:
    """The model's weights from the seed, on the device, in the reference
    layout; BatchNorm statistics measured by the reference on seeded
    calibration clips, each tower on its own CQT."""
    m = ctx.model
    ref = reference.of(m)
    sd = ref.init_weights(m, ctx.sub_seed(1), ctx.device)
    sr = ctx.mix["sr"]
    n = CALIBRATION_SECONDS * sr
    clips = synth.pcm16_batch([n] * CALIBRATION_CLIPS, n, sr,
                              ctx.sub_seed(2), ctx.device)
    hop = int(round(sr / m["frames"]))
    mels = [ref_cqt.cqt(clips, sr=sr, hop=hop, bins_per_octave=b,
                        octaves=m["octaves"],
                        stream_dtype=getattr(torch, m["cqt_stream_dtype"]))
            for b in ref_serve.bins_of(m)]
    seq = torch.full((CALIBRATION_CLIPS,), 1 + n // hop, dtype=torch.int32,
                     device=ctx.device)
    with torch.no_grad():
        ref.forward(sd, m, mels, seq, mode="calibrate")
    return sd


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def checked(ctx: Context, numbers: dict) -> tuple:
    """({name: {"value", "limit"}} of each compared number, in the order
    of the cell's limits file, a number the check could not produce
    reading inf (fails); {name: value} of the numbers the limits file
    lists as read but not compared)."""
    out, read = {}, {}
    for name, limit in ctx.limits["limits"].items():
        v = numbers.get(name, math.inf)
        out[name] = {"value": float(v), "limit": float(limit)}
    for name, v in numbers.items():
        if name in ctx.limits.get("not_compared", ()):
            read[name] = float(v)
        elif name not in out:
            raise CellError(f"{ctx.cell['name']}: the check compares "
                            f"{name!r}, which limits/ has no limit for")
    return out, read


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool,
             device, started: float | None = None,
             stand_in: str | None = None) -> dict:
    """One run of one cell: set-up, the measured window, the traced
    readings when `trace`, the check. Returns the result's fields. With
    `stand_in`, the reference stands in the system's place (the control
    and the faults, `stand_in.py`)."""
    started = time.perf_counter() if started is None else started
    ctx = context(root, workload, seed, device, stand_in)
    kind = traffic_kind(ctx)
    per_layer = metrics_of(ctx, "per_layer") if trace else []
    readers = {m["name"]: reader(ctx, m["name"]) for m in per_layer}
    cell = kind.Traffic(ctx)
    try:
        return _run(ctx, cell, per_layer, readers, seconds, trace, started)
    finally:
        cell.close()


def _run(ctx, cell, per_layer, readers, seconds, trace, started) -> dict:
    cell.setup(weights(ctx))
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - started
    cell.window(seconds, traced=trace)
    peak = (torch.cuda.max_memory_allocated()
            if ctx.device.type == "cuda" else 0)
    result = {"attempted": cell.attempted, "failed": cell.failed,
              "peak": peak}
    if trace:
        readings = cell.trace()
        values = {}
        for m in per_layer:
            v = readers[m["name"]].read(readings)
            if v is not None:
                values[m["name"]] = {"value": float(v), "unit": m["unit"]}
        result["metrics"] = values
        result["busy_s"] = readings.busy_s
        result["window_s"] = readings.profile.window_s
        result["breakdown"] = readings.breakdown()
    else:
        e2e = cell.end_to_end()
        e2e["setup_s"] = setup_s
        result["metrics"] = {m["name"]: {"value": float(e2e[m["name"]]),
                                         "unit": m["unit"]}
                             for m in metrics_of(ctx, "end_to_end")}
    cell.release()
    result["checks"], result["readings"] = checked(ctx, cell.check())
    result["correct"] = cell.failed == 0 and all(
        c["value"] <= c["limit"] for c in result["checks"].values())
    return result
