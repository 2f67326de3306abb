"""PyTorch port on the card: `make_batch` stages each served batch in the
estimator's page-locked buffer and copies it without blocking.

 * successive batches of other contents and lengths, int16 and float32,
   reach the card equal to the fresh path's batch, and a batch already
   handed out is not touched by the next one's packing;
 * `akx.h2d` counts every byte as page-locked below STAGING_CAP_BYTES,
   none above it (the cap lowered here only), where the fresh, pageable
   path serves;
 * two threads serving through one estimator each get their own batch.

Marked `card`; here without CUDA each skips. This file imports nothing of
JAX, so on the card it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_staging_card.py
"""

import concurrent.futures as futures

import numpy as np
import pytest
import torch

from audio_key_estimation_torch import predict
from audio_key_estimation_torch.config import Config
from audio_key_estimation_torch.models import build_model
from audio_key_estimation_torch.predict import KeyEstimator
from audio_key_estimation_torch.utils.profiling import totals

SR = 22050
CFG = dict(octaves=4, num_layers=2, conv_layers=1, n_filters=2,
           kernel_size=3, head_layers=1)

pytestmark = pytest.mark.card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs the card (CUDA is not available here)")
    return torch.device("cuda")


@pytest.fixture
def est(card):
    cfg = Config(**CFG)
    return KeyEstimator(cfg, build_model(cfg).state_dict(), device=card,
                        bucket_seconds=(2, 6))


def waves(rng, lengths, kind="int16"):
    out = []
    for i, n in enumerate(lengths):
        w = rng.integers(-32768, 32768, n).astype(np.int16)
        if kind == "float32" and i % 2 == 0:
            w = w.astype(np.float32) / 32768.0
        out.append(w)
    return out


def fresh(est, ws):
    batch, seq, hop = est.host_batch(ws, SR)
    return torch.from_numpy(batch), torch.from_numpy(seq), hop


def h2d():
    return dict(totals().get("akx.h2d", {}))


@pytest.mark.parametrize("kind", ["int16", "float32"])
def test_staged_batches_equal_the_fresh_path(est, kind):
    rng = np.random.default_rng(0)
    sizes = [[6 * SR, 5 * SR, 4 * SR], [SR, 2 * SR - 7, 300],
             [3 * SR], [5 * SR + 11, 17]]
    before, kept = h2d(), []
    for lengths in sizes:
        ws = waves(rng, lengths, kind)
        got = est.make_batch(ws, SR)
        want = fresh(est, ws)
        kept.append((got, want))
        torch.cuda.synchronize()
        for g, w in zip(got[:2], want[:2]):
            assert g.device.type == "cuda" and g.dtype == w.dtype
            assert torch.equal(g.cpu(), w)
        assert got[2] == want[2]
    for got, want in kept:          # later packing left them alone
        assert torch.equal(got[0].cpu(), want[0])
    after = h2d()
    moved = after["bytes"] - before.get("bytes", 0)
    assert moved > 0
    assert after["pinned_bytes"] - before.get("pinned_bytes", 0) == moved


def test_a_batch_over_the_cap_takes_the_pageable_path(est, monkeypatch):
    rng = np.random.default_rng(1)
    ws = waves(rng, [2 * SR, SR])
    before = h2d()
    est.make_batch(ws, SR)
    middle = h2d()
    staged = middle["pinned_bytes"] - before.get("pinned_bytes", 0)
    assert staged == middle["bytes"] - before.get("bytes", 0) > 0
    monkeypatch.setattr(predict, "STAGING_CAP_BYTES", staged - 1)
    got = est.make_batch(ws, SR)
    after = h2d()
    assert after["pinned_bytes"] == middle["pinned_bytes"]
    assert after["bytes"] - middle["bytes"] == staged
    want = fresh(est, ws)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def test_two_threads_through_one_estimator(est):
    rng = np.random.default_rng(2)
    jobs = [waves(rng, [int(n) for n in rng.integers(SR, 6 * SR, 3)])
            for _ in range(16)]

    def serve(ws):
        batch, seq, _ = est.make_batch(ws, SR)
        torch.cuda.current_stream().synchronize()
        return batch.cpu(), seq.cpu()

    with futures.ThreadPoolExecutor(max_workers=2) as tp:
        results = list(tp.map(serve, jobs, timeout=120))
    for ws, (batch, seq) in zip(jobs, results):
        want = fresh(est, ws)
        assert torch.equal(batch, want[0]) and torch.equal(seq, want[1])
