"""BENCHMARK.json keeps to the benchmark's contract, and every name it
gives has its file: configuration, mix, traffic kind, limits, reader."""

import json
import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench(repo):
    return json.loads((repo / "BENCHMARK.json").read_text())


def test_keys_and_names(bench, repo):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert all("/" not in w or w.startswith("benchmark") for w in
               bench["command"]) and len(bench["command"]) <= 32
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert (repo / c["file"]).exists()
        assert json.loads((repo / c["file"]).read_text())["name"] == c["name"]
    names = [w["name"] for w in bench["workloads"]]
    assert len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    assert {w["config"] for w in bench["workloads"]} == {
        c["name"] for c in bench["configs"]}


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads",
                                                              cells))
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for cell in cells:
        ends = [m for m in bench["end_to_end"]
                if cell in m.get("workloads", cells)]
        assert len(ends) >= 2
        assert any(cell in m["workloads"] for m in bench["per_layer"])


def test_every_name_has_its_file(bench, repo):
    for w in bench["workloads"]:
        ctx = harness.context(repo, w["name"], 1, "cpu")
        harness.traffic_kind(ctx)
        assert set(ctx.limits["limits"])
    for m in bench["per_layer"]:
        ctx = harness.context(repo, m["workloads"][0], 1, "cpu")
        mod = harness.reader(ctx, m["name"])
        assert (mod.UNIT, mod.MOVES, mod.SOURCE, mod.LAYER) == (
            m["unit"], m["moves"], m["source"], m["layer"])
