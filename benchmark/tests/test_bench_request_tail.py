"""The files cell's request tail, read per layer: a traced run reports
`request_p95_ms.files` from every request of its window, an untraced
run reports only the cell's end-to-end metrics, and the reader gives
nothing where the window served no request."""

import math
from types import SimpleNamespace

import numpy as np
import pytest

import bench_tiny
from benchmark import harness
from benchmark.harness import run_cell

CELL = "tiny.default.files"
NAME = "request_p95_ms.files"
SEED = 2**31 + 11


@pytest.fixture
def tiny(checkout):
    bench_tiny.add_tiny_cells(checkout)
    return checkout


@pytest.mark.parametrize("trace", [False, True])
def test_the_tail_is_read_per_layer(tiny, trace):
    res = run_cell(tiny, CELL, SEED, 0.3, trace, "cpu")
    assert res["correct"], res["checks"]
    if not trace:
        assert set(res["metrics"]) == {"served_audio_min_per_s", "setup_s"}
        return
    v = res["metrics"][NAME]
    assert v["unit"] == "ms" and math.isfinite(v["value"]) and v["value"] > 0


def test_the_reader_takes_the_95th_percentile_of_the_window(repo):
    ctx = harness.context(repo, "default.files", 1, "cpu")
    mod = harness.reader(ctx, NAME)
    lat = tuple(np.linspace(0.010, 0.109, 100))
    assert mod.read(SimpleNamespace(latencies_s=lat)) == pytest.approx(
        1e3 * np.percentile(lat, 95))
    assert mod.read(SimpleNamespace(latencies_s=())) is None
