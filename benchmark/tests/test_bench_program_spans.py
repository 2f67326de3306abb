"""The per-layer metrics that read the program's own spans and counters
(`benchmark/program.py`): each reports in a traced run of its tiny cell
(h2d_gb_per_s, which reads the card's copy rows, from a profile that has
them), none where the reference stands in the system's place, and none,
without raising, from a program that has no tracer."""

import math
from types import SimpleNamespace

import pytest
import torch

import bench_tiny
from benchmark import harness
from benchmark.harness import run_cell

READ = {"tiny.default.files": {"pack_ms_per_audio_min", "h2d_gb_per_s",
                               "useful_sample_share.files"},
        "tiny.default.train": {"feed_wait_ms_per_step",
                               "useful_frame_share.train"}}
DEVICE = {"h2d_gb_per_s"}
SEED = 2**31 + 7


@pytest.fixture
def tiny(checkout):
    bench_tiny.add_tiny_cells(checkout)
    return checkout


@pytest.mark.parametrize("cell", sorted(READ))
def test_a_traced_run_reads_the_programs_spans(tiny, cell):
    res = run_cell(tiny, cell, SEED, 0.3, True, "cpu")
    assert res["correct"], res["checks"]
    got = {k: v["value"] for k, v in res["metrics"].items() if k in READ[cell]}
    assert set(got) == READ[cell] - DEVICE     # the CPU has no copy rows
    for name, v in got.items():
        assert math.isfinite(v) and v >= 0
        if "share" in name:
            assert 0 < v <= 100


def test_the_reference_in_the_systems_place_gives_them_nothing(tiny):
    """The training cell's stand-in runs the program's feed (so its
    akx.pad and akx.feed_wait spans are there), but no akx.train_step."""
    cell = "tiny.default.train"
    res = run_cell(tiny, cell, SEED, 0.3, True, "cpu", stand_in="tf32")
    assert not READ[cell] & set(res["metrics"])


def readers(repo):
    for cell, names in READ.items():
        ctx = harness.context(repo, cell.removeprefix("tiny."), 1, "cpu")
        yield from (harness.reader(ctx, name) for name in sorted(names))


def test_a_slice_without_the_programs_root_span_gives_nothing(repo):
    """A profiled slice in which neither a request nor a step of the
    program ran (the files cell's stand-in serves without the program)."""
    from audio_key_estimation_torch.utils.profiling import span
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("akx.pack", samples=1, samples_padded=2):
            pass
        with span("akx.feed_wait"):
            pass
    for mod in readers(repo):
        assert mod.read(SimpleNamespace(calls=2, call_minutes=1.0)) is None


def test_h2d_reads_the_spans_bytes_over_the_copy_rows_device_time(repo):
    """The bytes of the slice's akx.h2d spans over the device time of its
    host-to-device copy rows; no other row counts."""
    from audio_key_estimation_torch.utils.profiling import span
    from benchmark.yardstick.profile import Profile, Row
    ctx = harness.context(repo, "default.files", 1, "cpu")
    mod = harness.reader(ctx, "h2d_gb_per_s")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("akx.request", request=True):
            for _ in range(2):
                with span("akx.h2d", bytes=3_000_000):
                    pass
    rows = [Row("Memcpy HtoD (Pageable -> Device)", 0.0, 1000.0, 0.0),
            Row("Memcpy HtoD (Pageable -> Device)", 2000.0, 2500.0, 0.0),
            Row("Memcpy DtoH (Device -> Pageable)", 3000.0, 9000.0, 0.0),
            Row("conv7_kernel", 0.0, 9000.0, 0.0)]
    got = mod.read(SimpleNamespace(profile=Profile(rows, [], 0.01)))
    assert got == pytest.approx(6e6 / 1.5e-3 / 1e9)
    assert mod.read(SimpleNamespace(profile=Profile(rows[2:], [], 0.01))) \
        is None


def test_a_program_without_the_tracer_gives_nothing(repo, monkeypatch):
    """A commit older than the tracer: its profiling module has no
    spans() or totals()."""
    from audio_key_estimation_torch.utils import profiling
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(profiling, "totals")
    for mod in readers(repo):
        assert mod.read(SimpleNamespace(calls=2, call_minutes=1.0)) is None
