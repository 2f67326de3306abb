"""The port's bench (`audio_key_estimation_torch/bench.py`) and its serving
loop (`audio_key_estimation_torch/scripts/serving_loop.py`) on the CPU.

The bench runs as a user runs it, in a subprocess, at a small size with
`--device cpu`, and without it on this machine, which has no CUDA: then
it reports an error, never a CPU number. The serving loop is held to a
serial run of the same steps with its consumer slowed, so that a buffer
handed back to the producer too early would show, and it refuses a batch
that ingest did not write into its buffer. The bench's timed call is the
code `KeyEstimator.outputs` runs (same outputs, in IEEE float32), and
its front-end FLOP count is checked against one worked out by hand. The
card's numbers come from `chip_smoke.py` phase 7b and the bench run
there.
"""

import json
import os
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from audio_key_estimation_torch import bench
from audio_key_estimation_torch.config import Config
from audio_key_estimation_torch.data import audio_io
from audio_key_estimation_torch.models import build_model
from audio_key_estimation_torch.ops.cqt import (CQTParams, kernel_bank,
                                                reference_hop)
from audio_key_estimation_torch.predict import KeyEstimator
from audio_key_estimation_torch.scripts import serving_loop as SL
from audio_key_estimation_torch.utils import precision

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the default model needs >= 26 frames (its time pools and the 7-wide
# pitch-class conv): 6 s at hop 4410 gives 31
SMALL = ("--device", "cpu", "--clip_seconds", "6", "--batches", "2",
         "--loop_batches", "2", "--loop_rows", "6")
TINY = dict(octaves=3, num_layers=2, conv_layers=1, n_filters=2,
            kernel_size=3, head_layers=1)
LOOP_SR = 8000
LOOP_SECONDS = 3


def run_bench(*args) -> dict:
    """The bench's final report; every stdout line must be JSON."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "audio_key_estimation_torch.bench", *args],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    reports = [json.loads(line) for line in lines]
    return reports[-1]


def test_bench_reports_on_the_cpu():
    rep = run_bench(*SMALL)
    assert "error" not in rep, rep["error"]
    assert rep["metric"] and rep["unit"]
    assert rep["value"] > 0
    assert rep["fronts"]["kernels"] == {"not_run": "cpu"}
    plain = rep["fronts"]["plain"]
    assert set(plain) == {"float32", "bfloat16"}
    for cells in plain.values():
        cell = cells["b2"]
        assert cell["pipeline_ms"] > 0 and cell["first_call_s"] > 0
        assert 0 < cell["mfu"] <= 1
    assert (rep["front_end"], rep["batch_clips"], rep["dtype"]) == (
        "plain", 2, "float32")
    assert rep["value"] == plain["float32"]["b2"]["audio_min_per_s"]
    assert set(rep["stages"]) == {
        "decode_ms_per_audio_min", "cqt_ms_per_audio_min",
        "model_ms_per_audio_min", "model_plain_ms_per_audio_min",
        "pipeline_ms_per_audio_min"}
    assert all(v > 0 for v in rep["stages"].values())
    assert 0 < rep["mfu"] <= 1
    assert rep["mfu_peak"]["flops_per_s"] == 67e12
    assert rep["mfu_peak"]["dtype"] == "float32"
    loop = rep["end_to_end"]["b2"]
    assert rep["end_to_end_audio_min_per_s"] == loop["audio_min_per_s"] > 0
    assert loop["steps"] == 3 and loop["batch"] == 2
    # three steps of two of the 16 files: each reads other files, and
    # each step equals the same step computed alone
    assert len(set(loop["serial"]["input_sums"])) == 3
    assert loop["input_sums"] == loop["serial"]["input_sums"]
    np.testing.assert_allclose(loop["loop_sums"],
                               loop["serial"]["loop_sums"], rtol=1e-6)
    assert 0 < loop["ingest_s"] <= loop["wall_s"]
    assert 0 < loop["step_s"] <= loop["wall_s"]
    assert loop["audio_min_per_s"] <= loop["ingest_audio_min_per_s"]
    assert rep["end_to_end_min_of_stages"] > 0
    assert rep["device"]["name"] == "cpu"
    assert rep["vs_baseline"] > 0 and rep["baseline"]["cpu_threads"] >= 1


def test_bench_without_cuda_reports_an_error_not_a_cpu_number():
    rep = run_bench("--clip_seconds", "6")
    assert rep["value"] == 0.0
    assert "CUDA" in rep["error"]
    assert rep["fronts"] == {} and "front_end" not in rep
    assert "end_to_end" not in rep and "baseline" not in rep


def _tiny_estimator(**kw) -> KeyEstimator:
    cfg = Config(**TINY, **kw)
    weights = build_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    return KeyEstimator(cfg, weights, device="cpu")


def _loop_corpus(root, n: int) -> list:
    rng = np.random.default_rng(3)
    t = np.arange(LOOP_SR * LOOP_SECONDS) / LOOP_SR
    paths = []
    for i in range(n):
        y = (0.4 * np.sin(2 * np.pi * 220 * 2 ** (i / 7) * t)
             + 0.05 * rng.standard_normal(t.shape))
        paths.append(str(root / f"c{i}.wav"))
        audio_io.write_wav(paths[-1], y, LOOP_SR)
    return paths


def test_serving_loop_with_a_slow_consumer_equals_a_serial_run(
        tmp_path, monkeypatch):
    """Six files, two a step, five steps: consecutive steps read
    different files, and the consumer sleeps inside each step. On the
    CPU the step reads the ingest buffer itself, so a buffer released
    before the step's scalar is read would be rewritten under it."""
    est = _tiny_estimator()
    paths = _loop_corpus(tmp_path, 6)
    L = LOOP_SR * LOOP_SECONDS
    want = SL.serial_sums(est, paths, L, 2, 5)
    assert len(set(want["loop_sums"][:3])) == 3
    assert len(set(want["input_sums"][:3])) == 3
    pipeline = SL.pipeline

    def slow(*a):
        time.sleep(0.05)
        return pipeline(*a)
    monkeypatch.setattr(SL, "pipeline", slow)
    res = SL.serving_loop(est, paths, L, batch=2, steps=5)
    np.testing.assert_allclose(res["loop_sums"], want["loop_sums"],
                               rtol=1e-6)
    assert res["input_sums"] == want["input_sums"]
    assert res["steps"] == 5 and res["batch"] == 2
    assert res["wall_s"] >= res["step_s"] >= 5 * 0.05
    assert 0 < res["ingest_s"] <= res["wall_s"]
    minutes = 5 * 2 * LOOP_SECONDS / 60
    assert res["audio_min_per_s"] == pytest.approx(minutes / res["wall_s"])


def _write_float32_wav(path, y, sr) -> str:
    data = np.asarray(y, "<f4").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 3, 1, sr, sr * 4, 4,
                                      32))
        f.write(b"data" + struct.pack("<I", len(data)) + data)
    return str(path)


@pytest.mark.parametrize("at", [0, 2], ids=["warm-up", "producer"])
def test_serving_loop_refuses_ingest_off_the_raw_path(tmp_path, at):
    """A float32 WAV makes ingest decode and pack a new float32 batch,
    leaving the loop's int16 buffer stale: the loop raises, whether the
    file comes in the untimed warm-up's step or in one the producer
    thread ingests (two files a step)."""
    est = _tiny_estimator()
    paths = _loop_corpus(tmp_path, 4)
    t = np.arange(LOOP_SR * LOOP_SECONDS) / LOOP_SR
    paths[at] = _write_float32_wav(tmp_path / "f.wav",
                                   0.3 * np.sin(2 * np.pi * 330 * t),
                                   LOOP_SR)
    threads = threading.active_count()
    with pytest.raises(RuntimeError, match="fell back off the raw path"):
        SL.serving_loop(est, paths, LOOP_SR * LOOP_SECONDS, batch=2,
                        steps=3)
    assert threading.active_count() == threads


def test_serving_loop_stops_its_producer_when_a_step_fails(tmp_path,
                                                          monkeypatch):
    est = _tiny_estimator()
    paths = _loop_corpus(tmp_path, 2)
    calls = []
    pipeline = SL.pipeline

    def failing(*a):
        calls.append(1)
        if len(calls) == 3:          # the warm-up, then the second step
            raise ValueError("step failed")
        return pipeline(*a)
    monkeypatch.setattr(SL, "pipeline", failing)
    threads = threading.active_count()
    with pytest.raises(ValueError, match="step failed"):
        SL.serving_loop(est, paths, LOOP_SR * LOOP_SECONDS, batch=2,
                        steps=6)
    assert threading.active_count() == threads


def test_serving_loop_main_refuses_a_missing_card():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SL.main()


@pytest.mark.parametrize("front", ["kernels", "plain"])
def test_bench_call_is_what_key_estimator_outputs_runs(front):
    """The bench's timed call on a small batch gives the outputs of
    KeyEstimator.outputs on the same waveforms and weights (no bucket
    padding on either side), and its scalar is their |sum|."""
    cfg = Config()
    weights = build_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    seconds = 6
    L = bench.SR * seconds
    rng = np.random.default_rng(1)
    waves = [np.round(rng.standard_normal(L) * 3000).astype(np.int16)
             for _ in range(3)]
    est = bench.estimator(front, "float32", weights, "cpu")
    est.bucket_seconds = (seconds,)
    want, seq = est.outputs(waves, bench.SR)
    hop = reference_hop(bench.SR, cfg.frames, cfg.window_size, L)
    got = SL.forward(est, torch.from_numpy(np.stack(waves)), bench.SR, hop,
                     torch.from_numpy(seq))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=0)
    scalar = SL.pipeline(est, torch.from_numpy(np.stack(waves)), bench.SR,
                         hop, torch.from_numpy(seq)).item()
    assert scalar == pytest.approx(sum(np.abs(w).sum() for w in want),
                                   rel=1e-6)


def test_bench_calls_run_in_ieee_float32_and_leave_the_callers_settings():
    """Under a caller that allows TF32 everywhere, the pipeline, the CQT
    alone and the model alone each compute with the pin in force, and
    the caller's settings are back afterwards."""
    est = _tiny_estimator()
    seen = []
    est.model.register_forward_pre_hook(
        lambda m, a: seen.append(precision.flags()))
    features = est.features

    def recording(*a):
        seen.append(precision.flags())
        return features(*a)
    est.features = recording
    L = LOOP_SR * LOOP_SECONDS
    hop = reference_hop(LOOP_SR, est.cfg.frames, est.cfg.window_size, L)
    y = torch.zeros(2, L, dtype=torch.int16)
    seq = torch.full((2,), 1 + L // hop, dtype=torch.int32)
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    try:
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        caller = precision.flags()
        SL.pipeline(est, y, LOOP_SR, hop, seq)
        bench.features_sum(est, y, LOOP_SR, hop)
        feats = SL.forward(est, y, LOOP_SR, hop, seq)
        bench.model_sum(est.model, est.features(y, LOOP_SR, hop), seq)
        after = precision.flags()
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
    assert feats and len(seen) == 7
    pinned = {"cudnn.conv": "ieee", "cudnn.rnn": "ieee",
              "cuda.matmul": "ieee", "cudnn.allow_tf32": False,
              "cuda.matmul.allow_tf32": False}
    # the hook outside a pin (est.features called directly) sees the
    # caller's settings; every call made by the bench sees the pin
    assert [s == pinned for s in seen] == [True] * 5 + [False, True]
    assert after == caller


def test_checksum_is_exact_and_tells_rows_apart():
    """The loop's input fingerprint: each row's int64 sum of samples
    times its row number from 1, summed, with no int16 overflow."""
    y = torch.tensor([[32767, 32767, 1], [-32768, 0, 5]], dtype=torch.int16)
    assert SL.checksum(y).item() == 1 * (32767 + 32767 + 1) + 2 * (-32768 + 5)
    assert SL.checksum(y.flip(0)).item() != SL.checksum(y).item()


def test_frontend_flops_by_hand():
    """2 octaves of 12 bins at 8000 Hz, hop 1000, one clip of 8000
    samples. The top octave's lowest filter (C2, 65.406 Hz) is the
    longest: Q = 1 / (2**(1/12) - 1) = 16.817, 16.817 * 8000 / 65.406 =
    2056.9 samples, so n_fft = 4096. T = 1 + 8000 // 1000 = 9 frames.
    Response: 2 octaves * 2 (cos, sin) * 2 (multiply, add) * 12 bins *
    4096 * 9 = 3 538 944. Decimation: one stream of (8000 - 1) // 2 + 1
    = 4000 samples, 2 * 49 each = 392 000. Total 3 930 944."""
    p = CQTParams(sr=8000, hop=1000, bins_per_octave=12, octaves=2)
    assert kernel_bank(p)["n_fft"] == 4096
    assert bench.frontend_flops(p, 8000, 1) == 3_930_944
    assert bench.frontend_flops(p, 8000, 5) == 5 * 3_930_944
