"""Measured end-to-end serving throughput: host ingest overlapped with the
device pipeline, not derived from min(host, device).

    python -m audio_key_estimation_torch.scripts.serving_loop

The PyTorch counterpart of the JAX package's `scripts/serving_loop.py`.
A producer thread ingests each step's WAVs into one of two reused int16
buffers (`audio_io.ingest_batch(out=...)`) while the consumer copies the
other to the device (`torch.from_numpy(buf).to(device)`, a pageable
copy) and runs the served pipeline on it: `KeyEstimator.features` then
its model, under `torch.inference_mode()` and IEEE float32, as
`KeyEstimator.outputs` runs them. Each step's outputs are reduced to one
scalar on the device and read with `.item()`; only then is the step's
buffer handed back to the producer, so the producer never rewrites a
buffer the step may still read (on the CPU the "copy" is the buffer
itself). Sustained audio-min/s over the steps is the result, beside
the producer's own ingest seconds and the consumer's step seconds in the
same window. `serial_sums` computes the same steps one after the other
from fresh arrays: the loop's scalars must equal them.

`main` takes no arguments and runs the loop as the JAX script does: 16
synthetic 120 s PCM16 WAVs (the bench's corpus, `make_corpus`), 20
steps of 16 clips, the default model with kernel C
(`Config(fused_convstack=True)`) on weights drawn from seed 0, on the
card (it raises without one). `audio_key_estimation_torch.bench`
imports `serving_loop`, `serial_sums`, `pipeline` and `make_corpus`.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time

import numpy as np
import torch

from audio_key_estimation_torch.config import Config
from audio_key_estimation_torch.data import audio_io
from audio_key_estimation_torch.models import build_model
from audio_key_estimation_torch.ops.cqt import reference_hop
from audio_key_estimation_torch.predict import KeyEstimator
from audio_key_estimation_torch.scripts.harness import log
from audio_key_estimation_torch.utils.precision import ieee_float32

SR = 22050
CLIP_SECONDS = 120
BATCH = 16
STEPS = 20
JOIN_S = 60.0


@torch.inference_mode()
@ieee_float32()
def forward(est: KeyEstimator, y: torch.Tensor, sr: int, hop: int,
            seq: torch.Tensor) -> tuple:
    """The model's outputs for the (B, L) signal batch `y` on est.device:
    the code `KeyEstimator.outputs` runs on one device (its CQT front-end
    through `est.features`, then `est.model`), with the same precision."""
    return est.model(*est.features(y, sr, hop), seq)


def reduce(outputs) -> torch.Tensor:
    """One float32 scalar on the outputs' device: the sum of |outputs|."""
    return sum(o.float().abs().sum() for o in outputs)


def pipeline(est: KeyEstimator, y: torch.Tensor, sr: int, hop: int,
             seq: torch.Tensor) -> torch.Tensor:
    """forward(...) reduced to one scalar on the device, not read back."""
    return reduce(forward(est, y, sr, hop, seq))


def step_rows(paths, batch: int, step: int) -> list:
    """The files of one step: the next `batch` paths, cycling through
    `paths` (every step reads the same files when len(paths) divides
    batch)."""
    return [paths[(step * batch + j) % len(paths)] for j in range(batch)]


def checksum(y: torch.Tensor) -> torch.Tensor:
    """An exact int64 fingerprint of a (B, L) int16 batch, on its device:
    each row's sum of samples times the row's number from 1, added up.
    The model's outputs barely move between clips at random weights;
    this tells any two steps of other files apart."""
    rows = torch.arange(1, y.shape[0] + 1, device=y.device)
    return (y.sum(1, dtype=torch.int64) * rows).sum()


def step_scalars(est: KeyEstimator, y: np.ndarray, sr: int,
                 lengths: np.ndarray, L: int) -> tuple:
    """One step on an ingested (B, L) int16 batch: copied to est.device,
    the served pipeline; returns (its outputs' scalar, the `checksum` of
    the device copy), read back with `.item()`."""
    cfg = est.cfg
    hop = reference_hop(sr, cfg.frames, cfg.window_size, L)
    # KeyEstimator.host_batch's lengths: frames of each unpadded clip
    seq = torch.from_numpy((1 + lengths // hop).astype(np.int32))
    yd = torch.from_numpy(y).to(est.device)
    check = checksum(yd)
    out = pipeline(est, yd, sr, hop, seq.to(est.device))
    return out.item(), check.item()


def serial_sums(est: KeyEstimator, paths, L: int, batch: int,
                steps: int) -> dict:
    """The first `steps` steps computed alone, one after the other: each
    step's files ingested into a fresh array, then `step_scalars`.
    Returns {"loop_sums", "input_sums"}: what `serving_loop`'s lists of
    those names must hold for these steps."""
    paths = [str(p) for p in paths]
    sums, checks = [], []
    for i in range(steps):
        y, lengths, sr = audio_io.ingest_batch(step_rows(paths, batch, i), L)
        s, c = step_scalars(est, y, sr[0], lengths, L)
        sums.append(s)
        checks.append(c)
    return {"loop_sums": sums, "input_sums": checks}


def serving_loop(est: KeyEstimator, paths, L: int, batch: int,
                 steps: int) -> dict:
    """`steps` steps of `batch` clips of L samples each, ingest
    overlapped with the device. Every file must be a mono PCM16 WAV at
    one rate: ingest that falls back off the raw path (which ignores its
    output buffer) raises RuntimeError, as does a failed step.

    Returns {"audio_min_per_s", "wall_s", "ingest_s", "step_s", "batch",
    "steps", "loop_sums", "input_sums"}: ingest_s sums the producer's
    ingests and step_s the consumer's steps (copy, pipeline, `.item()`)
    inside the timed window, each at most wall_s; loop_sums[i] is step
    i's scalar (`reduce` of its outputs) and input_sums[i] the
    `checksum` of the batch it copied to the device."""
    paths = [str(p) for p in paths]
    bufs = [np.empty((batch, L), np.int16) for _ in range(2)]
    ready = [threading.Semaphore(0), threading.Semaphore(0)]
    free = [threading.Semaphore(1), threading.Semaphore(1)]
    rates, lengths = [0, 0], [None, None]
    ingest_s, step_s = [0.0], 0.0
    failed: list = []
    stop = threading.Event()

    def ingest(step: int, k: int) -> None:
        got, n, sr = audio_io.ingest_batch(step_rows(paths, batch, step), L,
                                           out=bufs[k])
        # the decode fallback (not every file mono PCM16) returns a new
        # batch and leaves bufs[k] stale: fail loudly, not wrongly
        if got is not bufs[k]:
            raise RuntimeError(
                "ingest fell back off the raw path (got is not bufs[k]): "
                "every file must be a mono PCM16 WAV")
        if len(set(sr)) != 1:
            raise RuntimeError(f"one sample rate per step, got {set(sr)}")
        rates[k], lengths[k] = sr[0], n

    def producer() -> None:
        for i in range(steps):
            k = i % 2
            free[k].acquire()
            if stop.is_set():
                return
            try:
                t = time.perf_counter()
                ingest(i, k)
                ingest_s[0] += time.perf_counter() - t
            except Exception as e:          # handed to the consumer
                failed.append(e)
                ready[k].release()
                return
            ready[k].release()

    # warm-up, untimed: the first ingest, the kernels' build and first call
    ingest(0, 0)
    step_scalars(est, bufs[0], rates[0], lengths[0], L)

    th = threading.Thread(target=producer, daemon=True)
    sums, checks = [], []
    t0 = time.perf_counter()
    th.start()
    try:
        for i in range(steps):
            k = i % 2
            ready[k].acquire()
            if failed:
                raise failed[0]
            t = time.perf_counter()
            s, c = step_scalars(est, bufs[k], rates[k], lengths[k], L)
            step_s += time.perf_counter() - t
            sums.append(s)
            checks.append(c)
            # released only after .item() has fenced the step: the
            # device copy (and on the CPU the pipeline itself) reads
            # bufs[k] until then
            free[k].release()
        wall = time.perf_counter() - t0
    finally:
        stop.set()
        for f in free:
            f.release()
        th.join(JOIN_S)
    if th.is_alive():
        raise RuntimeError(f"the ingest thread outlived its {JOIN_S} s join")
    audio_min = steps * batch * L / rates[0] / 60.0
    return {"audio_min_per_s": audio_min / wall, "wall_s": wall,
            "ingest_s": ingest_s[0], "step_s": step_s, "batch": batch,
            "steps": steps, "loop_sums": sums, "input_sums": checks}


def make_corpus(root: str, n: int, sr: int, seconds: int) -> list:
    """The JAX bench's corpus (`bench.py` make_corpus): n deterministic
    clips of two partials (f0 = 110 Hz * 2**(i/5) and 1.5 f0) plus noise
    (seed 0), written as mono PCM16 WAVs at sr."""
    rng = np.random.default_rng(0)
    t = np.arange(sr * seconds) / sr
    paths = []
    for i in range(n):
        f0 = 110.0 * 2 ** (i / 5)
        y = (0.4 * np.sin(2 * np.pi * f0 * t)
             + 0.2 * np.sin(2 * np.pi * f0 * 1.5 * t)
             + 0.05 * rng.normal(size=t.shape)).astype(np.float32)
        paths.append(os.path.join(root, f"bench_{i}.wav"))
        audio_io.write_wav(paths[-1], y * 0.5, sr)
    return paths


def main() -> dict:
    cfg = Config(fused_convstack=True)
    weights = build_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    est = KeyEstimator(cfg, weights)
    with tempfile.TemporaryDirectory() as td:
        paths = make_corpus(td, BATCH, SR, CLIP_SECONDS)
        res = serving_loop(est, paths, SR * CLIP_SECONDS, BATCH, STEPS)
    log(f"serving loop: {STEPS} steps x {BATCH} clips in "
        f"{res['wall_s']:.2f} s -> {res['audio_min_per_s']:.1f} audio-min/s "
        f"end to end on {est.device} (measured, ingest overlapped)")
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
