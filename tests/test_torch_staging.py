"""PyTorch port: packing a served batch in place into a reused buffer.

 * `pack_batch(out=)` equals a fresh `pack_batch` (itself equal to the JAX
   package's), int16 and float32, serially and on a thread pool, over one
   buffer reused for long rows, then shorter rows (stale tails zeroed),
   then fewer waveforms padded by `n_rows` (pad rows zeroed);
 * an `out` of the wrong shape, dtype or layout, or too small for the
   waveforms, raises;
 * on the CPU `make_batch` stages nothing: successive batches share no
   memory and `akx.h2d` counts no page-locked bytes;
 * the benchmark's `pinned_h2d_share.files` reads the `akx.h2d` counts,
   and nothing from a program that does not count page-locked bytes.

The card's side (the page-locked buffer, its asynchronous copy, the cap)
is in tests/test_torch_staging_card.py.
"""

import concurrent.futures as futures
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_key_estimation_tpu.data import audio_io as jax_audio_io
from audio_key_estimation_torch.config import Config
from audio_key_estimation_torch.data import audio_io
from audio_key_estimation_torch.models import build_model
from audio_key_estimation_torch.predict import KeyEstimator
from audio_key_estimation_torch.utils import profiling
from audio_key_estimation_torch.utils.profiling import span, totals

REPO = Path(__file__).resolve().parents[1]
PAD, ROWS = 1000, 3
SR = 8000


def pcm(rng, n):
    return rng.integers(-32768, 32768, n).astype(np.int16)


def sequence(rng, kind):
    """Three batches for one (ROWS, PAD) buffer: long rows, shorter rows,
    then one waveform and two pad rows."""
    def wave(n, i):
        if kind == "float32" and i % 2 == 0:
            return rng.standard_normal(n).astype(np.float32)
        return pcm(rng, n)
    lengths = [[PAD, 990, 951], [120, 7, 333], [64]]
    return [[wave(n, i) for i, n in enumerate(ls)] for ls in lengths]


@pytest.fixture(params=["serial", "pool"])
def pool(request, monkeypatch):
    # pieces of 64 samples: every row is many pieces, split mid-wave
    monkeypatch.setattr(audio_io, "PACK_PIECE", 64)
    if request.param == "serial":
        yield None
        return
    with futures.ThreadPoolExecutor(max_workers=4) as tp:
        yield tp


@pytest.mark.parametrize("kind", ["int16", "float32"])
def test_pack_into_a_reused_buffer_equals_a_fresh_pack(rng, pool, kind):
    dtype = np.int16 if kind == "int16" else np.float32
    out = np.full((ROWS, PAD), 1234, dtype)       # stale from the start
    for waves in sequence(rng, kind):
        fresh = audio_io.pack_batch(waves, PAD, n_rows=ROWS)
        np.testing.assert_array_equal(
            fresh, jax_audio_io.pack_batch(waves, PAD, n_rows=ROWS))
        got = audio_io.pack_batch(waves, PAD, n_rows=ROWS, out=out,
                                  pool=pool)
        assert got is out and got.dtype == fresh.dtype == dtype
        # bit for bit: the int16 members of a float32 batch too
        assert got.tobytes() == fresh.tobytes()


def test_the_float32_path_scales_int16_members_as_the_fresh_pack(rng):
    waves = [pcm(rng, 50), rng.standard_normal(40).astype(np.float64)]
    out = np.full((2, 64), np.nan, np.float32)
    got = audio_io.pack_batch(waves, 64, out=out)
    assert got.tobytes() == audio_io.pack_batch(waves, 64).tobytes()
    assert audio_io.batch_dtype(waves) == np.float32
    assert audio_io.batch_dtype(waves[:1]) == np.int16


@pytest.mark.parametrize("bad", [
    np.zeros((ROWS + 1, PAD), np.int16),                  # shape
    np.zeros((ROWS, PAD), np.float32),                    # dtype
    np.zeros((PAD, ROWS), np.int16).T,                    # layout
    np.zeros((ROWS, 2 * PAD), np.int16)[:, ::2],          # strided
], ids=["shape", "dtype", "fortran", "strided"])
def test_a_wrong_out_raises(rng, bad):
    waves = [pcm(rng, 10), pcm(rng, 20)]
    with pytest.raises(ValueError, match="out must be C-contiguous"):
        audio_io.pack_batch(waves, PAD, n_rows=ROWS, out=bad)


@pytest.mark.parametrize("n_waves,length", [(ROWS + 1, 10), (2, PAD + 1)],
                         ids=["too_many", "too_long"])
def test_waveforms_that_do_not_fit_the_out_raise(rng, n_waves, length):
    waves = [pcm(rng, length) for _ in range(n_waves)]
    with pytest.raises(ValueError, match="do not fit"):
        audio_io.pack_batch(waves, PAD, n_rows=ROWS,
                            out=np.zeros((ROWS, PAD), np.int16))


def test_cpu_batches_are_fresh_and_count_no_pinned_bytes(rng):
    cfg = Config(octaves=4, num_layers=2, conv_layers=1, n_filters=2,
                 kernel_size=3, head_layers=1)
    est = KeyEstimator(cfg, build_model(cfg).state_dict(), device="cpu",
                       bucket_seconds=(1,))
    assert est._staging is None
    before = totals().get("akx.h2d", {})
    first = est.make_batch([pcm(rng, 5000), pcm(rng, 3000)], SR)
    kept = first[0].clone()
    second = est.make_batch([pcm(rng, 4000), pcm(rng, 8000)], SR)
    for a, b in zip(first[:2], second[:2]):
        assert a.device.type == "cpu"
        assert not np.may_share_memory(a.numpy(), b.numpy())
    assert torch.equal(first[0], kept)
    after = totals()["akx.h2d"]
    nbytes = 2 * (2 * SR * 2 + 2 * 4)
    assert after["bytes"] - before.get("bytes", 0) == nbytes
    assert after["pinned_bytes"] == before.get("pinned_bytes", 0)


def reader(name):
    path = REPO / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_pinned_share_reads_the_h2d_counts(monkeypatch):
    mod = reader("pinned_h2d_share.files")
    assert (mod.LAYER, mod.UNIT, mod.MOVES, mod.SOURCE) == (
        "batch + H2D (predict.KeyEstimator.make_batch)", "%",
        "served_audio_min_per_s", "program_counter")
    monkeypatch.setattr(profiling, "_totals", {})
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("akx.request", request=True):
            with span("akx.h2d", bytes=300):       # a program that counts
                pass                               # no page-locked bytes
    assert mod.read(None) is None
    monkeypatch.setattr(profiling, "_totals", {})
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("akx.request", request=True):
            with span("akx.h2d", bytes=100, pinned_bytes=100):
                pass
            with span("akx.h2d", bytes=300, pinned_bytes=0):
                pass
    assert mod.read(None) == 25.0
