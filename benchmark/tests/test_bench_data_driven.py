"""The harness is driven by data: a new configuration, mix, cell and
per-layer metric, each one new file plus entries in BENCHMARK.json, are
found and run by name, with no other file edited."""

import json
import os
import shutil
import subprocess
import sys

import bench_tiny

NEW_METRIC = '''"""Complete calls in the profiled slice."""

LAYER = "harness"
UNIT = "calls"
MOVES = "device_audio_min_per_s"
SOURCE = "program_counter"
READS = "the profiled slice's call count"


def read(r):
    return r.calls
'''


def test_new_files_are_found_by_name(checkout, repo):
    home = checkout / "benchmark"
    cfg = json.loads((home / "configs" / "pcn_default.json").read_text())
    cfg["name"] = "pcn_extra"
    (home / "configs" / "pcn_extra.json").write_text(json.dumps(cfg))
    (home / "mixes" / "extra_mix.json").write_text(
        json.dumps(bench_tiny.TINY_MIXES["tiny_resident"]))
    shutil.copy(home / "limits" / "default.resident.json",
                home / "limits" / "extra.resident.json")
    (home / "metrics" / "calls_profiled.py").write_text(NEW_METRIC)
    before = {p: p.read_bytes() for p in home.rglob("*") if p.is_file()}

    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "pcn_extra", "source": "s",
                             "file": "benchmark/configs/pcn_extra.json",
                             "reduced": [], "why": "w"})
    bench["workloads"].append({"name": "extra.resident",
                               "config": "pcn_extra",
                               "traffic": "extra_mix", "chips": 1,
                               "why": "w"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "default.resident" in m.get("workloads", ()):
            m["workloads"].append("extra.resident")
    bench["per_layer"].append({"name": "calls_profiled", "unit": "calls",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "harness",
                               "moves": "device_audio_min_per_s",
                               "workloads": ["extra.resident"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))

    code = ("import json, sys; from benchmark.harness import run_cell; "
            "r = run_cell('.', 'extra.resident', 2**31 + 11, 0.5, "
            "sys.argv[1] == '1', 'cpu'); "
            "print(json.dumps({'metrics': r['metrics'], "
            "'correct': r['correct']}))")
    env = dict(os.environ, PYTHONPATH=str(repo))
    for trace in ("0", "1"):
        out = subprocess.run([sys.executable, "-c", code, trace],
                             cwd=checkout, env=env, capture_output=True,
                             text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        if trace == "1":
            assert res["metrics"]["calls_profiled"]["value"] == 2
            assert res["metrics"]["calls_profiled"]["unit"] == "calls"
        else:
            assert set(res["metrics"]) == {"device_audio_min_per_s",
                                           "setup_s"}
    after = {p: p.read_bytes() for p in home.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert {p: b for p, b in after.items() if p in before} == {
        p: b for p, b in before.items() if "__pycache__" not in p.parts}
