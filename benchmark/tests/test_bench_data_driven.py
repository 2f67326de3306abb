"""The harness is driven by data: a new configuration, its own reference
model, mix, cell and per-layer metric, each one new file plus entries in
BENCHMARK.json, are found and run by name, with no other file edited."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import bench_tiny
from benchmark import harness
from benchmark.traffic import common

NEW_METRIC = '''"""Complete calls in the profiled slice."""

LAYER = "harness"
UNIT = "calls"
MOVES = "device_audio_min_per_s"
SOURCE = "program_counter"
READS = "the profiled slice's call count"


def read(r):
    return r.calls
'''

# appended to a copy of reference/model.py: counts each call by its kind
COUNTED = '''

CALLS = {}
_init_weights, _forward = init_weights, forward


def init_weights(cfg, seed, device):
    CALLS["init_weights"] = CALLS.get("init_weights", 0) + 1
    return _init_weights(cfg, seed, device)


def forward(sd, cfg, mels, seq, *, mode="eval"):
    key = f"forward.{mode}.{mels[0].device.type}"
    CALLS[key] = CALLS.get(key, 0) + 1
    return _forward(sd, cfg, mels, seq, mode=mode)
'''


def files(home) -> dict:
    return {p: p.read_bytes() for p in home.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def add_resident_cell(checkout, config: str, cell: str, **changes) -> None:
    """A configuration `config` (pcn_default with `changes`, a change to
    None taking the key out) and a cell `cell` of it on the tiny resident
    mix, under default.resident's limits and metrics: new files and
    BENCHMARK.json entries only."""
    home = checkout / "benchmark"
    cfg = json.loads((home / "configs" / "pcn_default.json").read_text())
    cfg = {k: v for k, v in dict(cfg, name=config, **changes).items()
           if v is not None}
    (home / "configs" / f"{config}.json").write_text(json.dumps(cfg))
    (home / "mixes" / f"{cell}_mix.json").write_text(
        json.dumps(bench_tiny.TINY_MIXES["tiny_resident"]))
    shutil.copy(home / "limits" / "default.resident.json",
                home / "limits" / f"{cell}.json")
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": config, "source": "s",
                             "file": f"benchmark/configs/{config}.json",
                             "reduced": [], "why": "w"})
    bench["workloads"].append({"name": cell, "config": config,
                               "traffic": f"{cell}_mix", "chips": 1,
                               "why": "w"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "default.resident" in m.get("workloads", ()):
            m["workloads"].append(cell)
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))


def run(checkout, repo, cell: str, trace: str, then: str = "") -> dict:
    """run_cell in a process of its own in `checkout`: its metrics and
    `correct`, and the names `then` (code run after it) puts in `out`."""
    code = ("import json, sys; from benchmark.harness import run_cell; "
            f"r = run_cell('.', '{cell}', 2**31 + 11, 0.5, "
            "sys.argv[1] == '1', 'cpu'); "
            "out = {'metrics': r['metrics'], 'correct': r['correct']}; "
            f"{then}\nprint(json.dumps(out))")
    env = dict(os.environ, PYTHONPATH=str(repo))
    out = subprocess.run([sys.executable, "-c", code, trace], cwd=checkout,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_new_files_are_found_by_name(checkout, repo):
    home = checkout / "benchmark"
    (home / "metrics" / "calls_profiled.py").write_text(NEW_METRIC)
    before = files(home)
    add_resident_cell(checkout, "pcn_extra", "extra.resident")
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "calls_profiled", "unit": "calls",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "harness",
                               "moves": "device_audio_min_per_s",
                               "workloads": ["extra.resident"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))

    for trace in ("0", "1"):
        res = run(checkout, repo, "extra.resident", trace)
        if trace == "1":
            assert res["metrics"]["calls_profiled"]["value"] == 2
            assert res["metrics"]["calls_profiled"]["unit"] == "calls"
        else:
            assert set(res["metrics"]) == {"device_audio_min_per_s",
                                           "setup_s"}
    after = files(home)
    assert {p: b for p, b in after.items() if p in before} == before


def test_a_configuration_names_its_own_reference_model(checkout, repo):
    home = checkout / "benchmark"
    (home / "reference" / "counted.py").write_text(
        (home / "reference" / "model.py").read_text() + COUNTED)
    before = files(home)
    add_resident_cell(checkout, "pcn_counted", "counted.resident",
                      reference="counted")

    res = run(checkout, repo, "counted.resident", "1",
              then="from benchmark.reference import counted; "
                   "out['calls'] = counted.CALLS; out['model_loaded'] = "
                   "'benchmark.reference.model' in sys.modules")
    assert res["correct"]
    calls = res["calls"]
    assert calls["init_weights"] >= 1            # the weights
    assert calls["forward.calibrate.cpu"] >= 1   # their BatchNorm statistics
    assert calls["forward.eval.cpu"] >= 1        # the check
    assert calls["forward.eval.meta"] >= 1       # model_flops (mfu.resident)
    assert "mfu.resident" in res["metrics"]
    assert not res["model_loaded"]
    after = files(home)
    assert {p: b for p, b in after.items() if p in before} == before


@pytest.mark.parametrize("reference", [None, "no_such_model", "serve"])
def test_a_configuration_without_a_reference_model_is_refused(
        checkout, reference):
    add_resident_cell(checkout, "pcn_bad", "bad.resident",
                      reference=reference)
    with pytest.raises(harness.CellError, match="pcn_bad"):
        harness.context(checkout, "bad.resident", 1, "cpu")


@pytest.mark.parametrize("cell,heights", [("default.resident", [288]),
                                          ("multi_scale.resident", [288, 96])])
def test_kernel_c_geometry_follows_the_configuration(repo, cell, heights):
    ctx = harness.context(repo, cell, 1, "cpu")
    sr, hop, L = 22050, 4410, 180 * 22050

    def geometry(**changes):
        return common.geometry(dict(ctx.model, **changes),
                               ctx.config["runtime"], B=256, L=L, sr=sr,
                               hop=hop, input_itemsize=2)

    plain = geometry()
    assert plain["stacks"] == [{"B": 256, "H": h, "T": 901,
                                "cins": [5, 8, 8]} for h in heights]
    for block in ("resblock", "denseblock"):
        g = geometry(**{block: True})
        assert g["stacks"] == [] and g["cqts"] == plain["cqts"]
