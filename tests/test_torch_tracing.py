"""PyTorch port: the tracer in utils/profiling.py and its spans at the
serving and training stages.

 * off a profiler session nothing is recorded, the span is the shared
   null context, and the counts still reach totals(), also from many
   threads at once;
 * under a CPU torch.profiler session spans nest with their parent and
   request id, a span inside one of its own name adds nothing, spans()
   holds the newest session's alone, and the ranges reach the Chrome
   trace as CPU ops, not user annotations (which the profiler mirrors
   onto the device's timeline);
 * predict_files is one akx.request whose children are the stages, and
   akx.pack counts the files' samples and rows x the bucket; the
   ensemble's forward is one akx.model;
 * a train_step fed through prefetch: akx.feed_wait, acc_grad akx.forward
   and akx.backward and one akx.optimizer under one akx.train_step, the
   frames totals of every padded batch, and the producer thread's spans
   carry no parent from the consumer.
"""

import json
import sys
import threading

import numpy as np
import pytest
import torch

from audio_key_estimation_torch.config import Config
from audio_key_estimation_torch.data import audio_io
from audio_key_estimation_torch.data.dataset import KeyDataset
from audio_key_estimation_torch.data.pipeline import prefetch
from audio_key_estimation_torch.models import build_model
from audio_key_estimation_torch.predict import KeyEstimator
from audio_key_estimation_torch.train import trainer
from audio_key_estimation_torch.utils import profiling
from audio_key_estimation_torch.utils.key_signatures import KEY_SIGNATURE_MAP
from audio_key_estimation_torch.utils.profiling import span, spans, totals

SERVE = dict(octaves=4, num_layers=2, conv_layers=1, n_filters=2,
             kernel_size=3, head_layers=1, cqt_conv_dtype="float32")
TRAIN = dict(octaves=4, num_layers=2, conv_layers=1, n_filters=2,
             kernel_size=3, head_layers=1, bucket_sizes=(32,), batch_size=2,
             acc_grad=2, frames=5)
SR = 8000
STAGES = {"akx.decode", "akx.pack", "akx.h2d", "akx.features", "akx.model",
          "akx.readback", "akx.name"}


def profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def delta(before: dict, name: str) -> dict:
    now = totals().get(name, {})
    return {k: v - before.get(name, {}).get(k, 0) for k, v in now.items()}


def test_off_a_session_nothing_is_recorded_and_counts_still_add():
    before, old = totals(), spans()
    with span("test.off", samples=5, bytes=3) as s:
        with span("test.inner", samples=2):
            pass
    assert s is None and span("test.a") is span("test.b")
    assert spans() == old
    assert delta(before, "test.off") == {"samples": 5, "bytes": 3}
    assert delta(before, "test.inner") == {"samples": 2}


def test_counts_from_many_threads_are_not_lost():
    """More threads than cores, switching every microsecond: a lost
    read-modify-write would leave the total short."""
    before = totals()
    threads, adds = 16, 500
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [
            span("test.threads", n=1, m=2) for _ in range(adds)])
            for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert delta(before, "test.threads") == {"n": threads * adds,
                                             "m": 2 * threads * adds}


def test_spans_nest_with_parent_and_request():
    with profiled():
        with span("test.root", request=True, clips=2):
            with span("test.child"):
                with span("test.child"):       # its own name: nothing more
                    with span("test.leaf"):
                        pass
        with span("test.step", request=41):
            pass
        with span("test.orphan"):
            pass
    got = {s.name: s for s in spans()}
    assert sorted(got) == ["test.child", "test.leaf", "test.orphan",
                           "test.root", "test.step"]
    root, child, leaf = got["test.root"], got["test.child"], got["test.leaf"]
    assert root.parent is None and root.counts == {"clips": 2}
    assert (child.parent, leaf.parent) == (root.id, child.id)
    assert root.request == child.request == leaf.request is not None
    assert got["test.step"].request == 41 and got["test.step"].parent is None
    assert got["test.orphan"].request is None
    assert root.start_ns <= child.start_ns <= leaf.start_ns
    assert leaf.end_ns <= child.end_ns <= root.end_ns


def test_spans_are_the_newest_sessions_alone():
    with profiled():
        with span("test.first"):
            pass
    assert [s.name for s in spans()] == ["test.first"]
    with span("test.between"):
        pass
    with profiled():
        with span("test.second"):
            pass
    assert [s.name for s in spans()] == ["test.second"]


def test_ranges_are_cpu_ops_in_the_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        with span("akx.test_range"):
            torch.ones(4).sum()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    cats = {e.get("cat") for e in events if e.get("name") == "akx.test_range"}
    assert cats == {"cpu_op"}


def wavs(tmp_path, seconds=(3.0, 2.2, 1.7)):
    paths = []
    for i, s in enumerate(seconds):
        t = np.arange(int(SR * s)) / SR
        p = str(tmp_path / f"s{i}.wav")
        audio_io.write_wav(p, 0.4 * np.sin(2 * np.pi * 220 * (i + 1) * t), SR)
        paths.append(p)
    return paths


def estimator(**kw):
    cfg = Config(**SERVE, **kw)
    return KeyEstimator(cfg, build_model(cfg).state_dict(), device="cpu",
                        bucket_seconds=(4,))


def test_predict_files_is_one_request_over_its_stages(tmp_path):
    paths = wavs(tmp_path)
    lengths = [len(audio_io.decode_audio(p, raw=True)[0]) for p in paths]
    est = estimator()
    est.predict_files(paths)
    before = totals()
    with profiled():
        preds = est.predict_files(paths)
    assert len(preds) == 3
    found = spans()
    roots = [s for s in found if s.name == "akx.request"]
    assert len(roots) == 1 and roots[0].parent is None
    root = roots[0]
    children = [s for s in found if s.parent == root.id]
    assert sorted(s.name for s in children) == sorted(STAGES)
    assert all(s.request == root.request for s in found)
    pack = next(s for s in found if s.name == "akx.pack")
    want = {"samples": sum(lengths), "samples_padded": 3 * 4 * SR}
    assert pack.counts == want and delta(before, "akx.pack") == want
    assert all(s.counts == {} for s in found
               if s.name not in ("akx.pack", "akx.h2d"))
    h2d = next(s for s in found if s.name == "akx.h2d")
    # the CPU takes the fresh, pageable path: nothing page-locked
    assert h2d.counts == {"bytes": 3 * 4 * SR * 2 + 3 * 4, "pinned_bytes": 0}


def test_the_ensemble_is_one_model_span():
    est = estimator(multi_scale=True)
    y = np.random.default_rng(0).normal(size=(2, 3 * SR)).astype(np.float32)
    with profiled():
        est.predict_waveforms(list(y), SR)
    names = [s.name for s in spans()]
    assert names.count("akx.model") == 1
    assert names.count("akx.features") == 1 and names.count("akx.request") == 1


def dataset(n: int, seed=0):
    cfg = Config(**TRAIN)
    rng = np.random.default_rng(seed)
    ds = KeyDataset(False, cfg, blacklist_path="", device="cpu")
    for i in range(n):
        t = int(rng.integers(16, 33))
        sig = np.zeros(24, np.float32)
        sig[int(rng.integers(0, 24))] = 1
        ds.items.append({
            "file": f"s{i}", "dataset": "synthetic",
            "mel": rng.normal(size=(cfg.pitches, t)).astype(np.float32),
            "key_labels": KEY_SIGNATURE_MAP[int(rng.integers(0, 21))]
            .astype(np.float32),
            "key_signature_id": sig,
            "tonic_labels": np.eye(12, dtype=np.float32)[
                int(rng.integers(0, 12))],
            "genre": np.zeros(11, np.float32), "seq_length": np.int32(t)})
    return cfg, ds


def feed(cfg, ds):
    step = cfg.batch_size * cfg.acc_grad
    for batch in ds.batches(step, shuffle=True, seed=1, drop_last=True):
        batch.pop("valid")
        batch = {k: np.reshape(v, (cfg.acc_grad, cfg.batch_size)
                               + v.shape[1:]) for k, v in batch.items()}
        yield trainer.to_device(batch, "cpu")


@pytest.fixture(scope="module")
def trained():
    """Two train steps fed through prefetch under one profiler session;
    the spans and the frames totals they left."""
    cfg, ds = dataset(8)
    state = trainer.create_train_state(cfg, 0, "cpu")
    step = trainer.make_train_step(cfg, 2, seed=0)
    before = totals()
    with profiled():
        for batch in prefetch(feed(cfg, ds)):
            step(state, batch)
    return cfg, ds, spans(), delta(before, "akx.pad")


def test_a_train_step_fed_through_prefetch(trained):
    cfg, ds, found, pad = trained
    steps = [s for s in found if s.name == "akx.train_step"]
    assert [(s.request, s.parent) for s in steps] == [(0, None), (1, None)]
    assert all(s.counts == {} for s in steps)
    for s in steps:
        names = sorted(c.name for c in found if c.parent == s.id)
        assert names == sorted(["akx.forward", "akx.backward"]
                               * cfg.acc_grad + ["akx.optimizer"])
        assert all(c.request == s.request for c in found
                   if c.parent == s.id)
    waits = [s for s in found if s.name == "akx.feed_wait"]
    assert len(waits) >= 2
    assert pad == {"frames": sum(int(it["seq_length"]) for it in ds.items),
                   "frames_padded": len(ds.items) * 32}


def test_producer_spans_carry_no_parent_from_the_consumer(trained):
    """The producer pads and copies while the consumer waits in
    akx.feed_wait or runs a step: its spans are roots of their own."""
    _, _, found, _ = trained
    produced = [s for s in found if s.name in ("akx.pad", "akx.to_device")]
    assert sorted(s.name for s in produced) == ["akx.pad"] * 2 + [
        "akx.to_device"] * 2
    assert all(s.parent is None and s.request is None for s in produced)
    consumer = {s.id for s in found
                if s.name in ("akx.feed_wait", "akx.train_step")}
    assert consumer and not {s.parent for s in found} & {
        s.id for s in produced}
