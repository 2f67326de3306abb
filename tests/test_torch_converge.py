"""PyTorch port: the convergence harnesses against the JAX package's.

`audio_key_estimation_torch/scripts/{train_converge_hard, train_converge,
train_smoke, local_ceiling_analysis}.py` against the JAX package's
`scripts/{train_converge_hard_tpu, train_converge_tpu, train_smoke_tpu,
local_ceiling_analysis}.py`:
 * corpus specs: with both packages' synthetic writers recording instead
   of rendering, the port's builders give the JAX script's songs, keys,
   seeds, timbres and segments, for the full and the pilot corpora,
   global and local;
 * rendered bytes: songs rendered by the port's process pool
   (data/render_pool.py, in an interpreter of its own) equal a serial
   render and the JAX package's, byte for byte;
 * the oracle ceiling: the port's local_ceiling_analysis.main equals the
   JAX script's on two corpora (every category within 1e-6) and, on the
   port's own local val corpus, reproduces the JAX run's ceiling to its
   four printed decimals at 5, 10 and 20 s windows;
 * tiny runs on the CPU: run_phase writes the JAX report layout (the
   epoch -1 row, the category columns) that parses back to the history;
   train_converge and train_smoke write theirs;
 * paths and devices: every report lands in converge_cuda/, none on a
   file the JAX scripts write; without CUDA each training harness raises
   unless the CPU is asked for.
Importing the JAX script sets JAX's compilation cache and platforms for
the process; `jax_hard` restores both.
"""

import importlib
import os
import sys

import jax
import numpy as np
import pytest
import torch

from audio_key_estimation_tpu.data import synthetic as jax_synthetic

from audio_key_estimation_torch.data import synthetic
from audio_key_estimation_torch.scripts import (local_ceiling_analysis,
                                                train_converge,
                                                train_converge_hard,
                                                train_smoke)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = train_converge_hard
# the tiny model of tests/test_torch_train.py, batch 2
TINY = dict(octaves=3, num_layers=2, conv_layers=1, n_filters=2,
            kernel_size=3, head_layers=1, batch_size=2)


@pytest.fixture(scope="module")
def jax_hard():
    """The JAX package's scripts/train_converge_hard_tpu.py, imported with
    the process's JAX settings and environment restored afterwards."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs", "jax_platforms")
    saved = {k: getattr(jax.config, k) for k in keys}
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    path = list(sys.path)
    try:
        mod = importlib.import_module("scripts.train_converge_hard_tpu")
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        if env is None:
            os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
        sys.path[:] = path
    return mod


# ---------------------------------------------------------------------------
# corpus specs
# ---------------------------------------------------------------------------

class Recorder:
    """Stands in for a synthetic module's corpus writers and
    polyphonic_wav: records each corpus's songs and segments and each
    song's render arguments (paths relative to `root`), writing only the
    split directories (the builders' .done markers go there)."""

    def __init__(self, root):
        self.root, self.corpora, self.renders = root, [], []

    def rel(self, path):
        return os.path.relpath(path, self.root)

    def giantsteps(self, root, songs, audio_fn=None):
        os.makedirs(root, exist_ok=True)
        self.corpora.append(("giantsteps", self.rel(root), list(songs)))
        for idx, (name, _, key, _) in enumerate(songs):
            audio_fn(os.path.join(root, "audio", f"{name}.wav"), key, idx)
        return root

    def winterreise(self, root, songs, local_segments=None, seconds=3.0,
                    audio_fn=None):
        os.makedirs(root, exist_ok=True)
        self.corpora.append(("winterreise", self.rel(root), list(songs),
                             local_segments, seconds))
        for perf, song, _, _ in songs:
            name = f"{perf}_{song}"
            audio_fn(os.path.join(root, f"{name}.wav"), name,
                     local_segments[name])
        return root

    def polyphonic(self, path, segments, *, seed=0, timbre_id=0):
        self.renders.append((self.rel(path), [tuple(s) for s in segments],
                             seed, timbre_id))

    def install(self, monkeypatch, module):
        monkeypatch.setattr(module, "make_giantsteps_corpus",
                            self.giantsteps)
        monkeypatch.setattr(module, "make_winterreise_corpus",
                            self.winterreise)
        monkeypatch.setattr(module, "polyphonic_wav", self.polyphonic)


@pytest.mark.parametrize("pilot", [False, True], ids=["full", "pilot"])
@pytest.mark.parametrize("kind", ["global", "local"])
def test_corpus_specs_equal_the_jax_script(kind, pilot, jax_hard, tmp_path,
                                           monkeypatch):
    """The port's builders give the JAX script's corpora: song lists
    (names, keys), local segments and seconds, and every song's render
    arguments (path, segments, seed, timbre), in the same order."""
    ref, ours = Recorder(str(tmp_path / "jax")), Recorder(
        str(tmp_path / "port"))
    ref.install(monkeypatch, jax_synthetic)
    ours.install(monkeypatch, synthetic)
    monkeypatch.setattr(jax_hard, "CORPUS_ROOT", ref.root)
    monkeypatch.setattr(H, "_workers", lambda: 1)   # render here: recorded
    build_ref = getattr(jax_hard, f"build_{kind}_corpus")
    build = getattr(H, f"build_{kind}_corpus")
    roots_ref = build_ref(pilot)
    roots = build(pilot, ours.root)
    assert [ref.rel(r) for r in roots_ref] == [ours.rel(r) for r in roots]
    assert ours.corpora == ref.corpora
    assert ours.renders == ref.renders
    n = {("global", False): 288, ("global", True): 72,
         ("local", False): 272, ("local", True): 18}[kind, pilot]
    assert len(ours.renders) == n
    assert len({r[2] for r in ours.renders}) == n      # one seed a song
    # the .done markers: a second call builds nothing
    before = len(ours.renders)
    build(pilot, ours.root)
    assert len(ours.renders) == before


def test_pool_render_is_byte_equal_to_serial_and_to_jax(tmp_path):
    """Three 6 s songs (one modulating) rendered by the port's pool of two
    processes (data/render_pool.py, run as its own interpreter) equal the
    port's serial render and the JAX package's polyphonic_wav, byte for
    byte."""
    jobs = [([(0.0, 6.0, 2, False)], 11, 3),
            ([(0.0, 6.0, 9, True)], 500_007, 101),
            ([(0.0, 2.5, 7, False), (2.5, 6.0, 4, True)], 700_002, 104)]

    def paths(tag):
        d = tmp_path / tag
        d.mkdir()
        return [str(d / f"{i}.wav") for i in range(len(jobs))]
    pool, serial, ref = paths("pool"), paths("serial"), paths("jax")
    H.render_songs([(p, *j) for p, j in zip(pool, jobs)], workers=2)
    H.render_songs([(p, *j) for p, j in zip(serial, jobs)], workers=1)
    for p, (segs, seed, timbre) in zip(ref, jobs):
        jax_synthetic.polyphonic_wav(p, segs, seed=seed, timbre_id=timbre)
    for a, b, c in zip(pool, serial, ref):
        data = open(a, "rb").read()
        assert len(data) > 6 * 22050 * 2
        assert data == open(b, "rb").read() == open(c, "rb").read()


# ---------------------------------------------------------------------------
# the oracle ceiling
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_ceiling():
    path = list(sys.path)
    try:
        return importlib.import_module("scripts.local_ceiling_analysis")
    finally:
        sys.path[:] = path


@pytest.mark.parametrize("corpus", ["pure", "mixed"])
def test_ceiling_equals_the_jax_script(corpus, jax_ceiling, tmp_path):
    """tests/test_data.py::test_local_oracle_ceiling_analysis's two
    corpora: the port's aggregate equals the JAX script's, every category
    within 1e-6."""
    root = str(tmp_path / corpus)
    songs = [("HU33", "D911-01", 220.0, "C:maj"),
             ("HU33", "D911-02", 220.0, "A:min")]
    segs = None if corpus == "pure" else {
        "HU33_D911-01": [(0.0, 20.0, "C:maj"), (20.0, 40.0, "G:maj")],
        "HU33_D911-02": [(0.0, 25.0, "A:min"), (25.0, 40.0, "E:min")]}
    synthetic.make_winterreise_corpus(root, songs, local_segments=segs,
                                      seconds=40.0)
    got = local_ceiling_analysis.main(root)
    want = jax_ceiling.main(root)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    if corpus == "pure":
        assert got["mirex"] == pytest.approx(1.0)
    else:
        assert 0.5 < got["mirex"] < 1.0


@pytest.mark.parametrize("window,ceiling", [(5, 0.9623), (10, 0.9151),
                                            (20, 0.7868)])
def test_ceiling_of_the_ports_local_val_corpus(window, ceiling, tmp_path,
                                               monkeypatch):
    """The port's full local val corpus (32 songs of 90 s; the layout and
    annotations written, the audio left empty: the oracle reads only the
    annotations) has the ceiling README gives for the JAX run's corpus,
    to its four decimals, at each window."""
    def touch(path, segments, *, seed=0, timbre_id=0):
        open(path, "w").close()
    monkeypatch.setattr(synthetic, "polyphonic_wav", touch)
    monkeypatch.setattr(H, "_workers", lambda: 1)
    _, va = H.build_local_corpus(False, str(tmp_path))
    agg = local_ceiling_analysis.main(va, window)
    assert round(agg["mirex"], 4) == ceiling, agg


# ---------------------------------------------------------------------------
# tiny runs on the CPU
# ---------------------------------------------------------------------------

def test_tiny_run_phase_writes_the_jax_report_layout(tmp_path,
                                                     monkeypatch):
    """run_phase("local", pilot) at the tiny widths (4 + 2 songs of 8 s, a
    2 s window, 2 epochs, fit seed 3) on the CPU: the report's table has
    the JAX report's header (CONVERGE_LOCAL_PILOT.md), the epoch -1 row
    first, the five category columns, and parses back to the history;
    the bookkeeping lines name the device and the seed."""
    out = str(tmp_path / "out")
    monkeypatch.setattr(H, "_workers", lambda: 1)
    r = H.run_phase("local", True, device="cpu",
                    corpus_root=str(tmp_path / "corpus"), out_dir=out,
                    sizes=(4, 2), seconds=8.0, epochs=2, seed=3,
                    loc_window_size=2, **TINY)
    assert r["report"] == os.path.join(out, "CONVERGE_LOCAL_W2_PILOT.md")
    text = open(r["report"]).read().splitlines()
    ref = open(os.path.join(REPO, "CONVERGE_LOCAL_PILOT.md")).read(
    ).splitlines()
    head = lambda lines: [i for i, ln in enumerate(lines)
                          if ln.startswith("| epoch")][0]
    t, t_ref = head(text), head(ref)
    assert text[0] == ref[0] == "# Hard-benchmark convergence: local"
    assert text[t:t + 2] == ref[t_ref:t_ref + 2]
    assert text[t + 2].startswith("| -1 | nan | ")
    assert text[2].startswith("Device: **cpu** (`cpu`) — PILOT RUN")
    rows = H.parse_report(r["report"])
    hist = r["history"]
    assert [row["epoch"] for row in rows] == [-1, 0, 1]
    assert len(rows) == len(hist) == 3
    for row, h in zip(rows, hist):
        for k, v in row.items():
            want = h.get(k, 0.0)
            if k == "epoch":
                assert v == want
            elif np.isnan(want):
                assert np.isnan(v), (k, v)
            else:
                assert abs(v - want) <= 5e-4 if k in (
                    "train_loss", "val_loss", "val_mirex") else 5e-3, (k, v)
    assert np.isnan(rows[0]["train_loss"]) and np.isfinite(
        rows[1]["train_loss"])
    cats = ("val_correct", "val_fifths", "val_relative", "val_parallel",
            "val_other")
    for row in rows:
        assert abs(sum(row[c] for c in cats) - 1.0) <= 3e-3, row
    assert text[-3].startswith("Untrained (epoch -1) val MIREX **")
    assert "Wall: fit" in text[-3] and text[-3].endswith("(cpu).")
    assert text[-1].startswith("The port (PyTorch) on `cpu`, seed 3;")


def test_tiny_train_converge_and_smoke(tmp_path):
    """train_converge (one scale walk per key and split, 6 s, 2 epochs)
    and train_smoke (4 songs of 6 s, 2 epochs) at the tiny widths on the
    CPU write their reports with finite losses."""
    out = str(tmp_path)
    c = train_converge.main("cpu", out, per_key=(1, 1), seconds=6.0,
                            epochs=2, **TINY)
    s = train_smoke.main("cpu", out, songs=4, seconds=6.0,
                         **dict(TINY, batch_size=2, acc_grad=2))
    assert c["report"] == os.path.join(out, "TRAIN_CONVERGE.md")
    assert s["report"] == os.path.join(out, "TRAIN_SMOKE.md")
    assert len(c["history"]) == 2 and len(s["history"]) == 2
    for h in c["history"] + s["history"]:
        assert np.isfinite(h["train_loss"]) and np.isfinite(h["val_loss"])
    text = open(c["report"]).read()
    assert "| epoch | train_loss | val_loss | val_mirex |" in text
    assert "Best val MIREX: **" in text
    text = open(s["report"]).read()
    assert ("| epoch | train_loss | val_loss | val_mirex | epoch_seconds |"
            in text)


# ---------------------------------------------------------------------------
# paths and devices
# ---------------------------------------------------------------------------

def test_reports_land_in_their_own_directory():
    """Every report the four harnesses can write (each phase, float32 and
    bf16, windows 5/10/20, full and pilot; the scale-walk run and the
    smoke) lies in converge_cuda/ and none is a file the JAX scripts
    write."""
    out = os.path.join(REPO, "converge_cuda")
    paths = {os.path.join(out, "TRAIN_CONVERGE.md"),
             os.path.join(out, "TRAIN_SMOKE.md")}
    jax_names = {"TRAIN_CONVERGE_TPU.md", "TRAIN_SMOKE_TPU.md"}
    for phase in H.PHASES:
        for dtype in ("float32", "bfloat16"):
            for window in (5, 10, 20):
                for pilot in (False, True):
                    cfg = H.make_config(phase, pilot, loc_window_size=window,
                                        dtype=dtype)
                    paths.add(H.report_path(phase, cfg, pilot))
                    jax_names.add(os.path.basename(
                        H.report_path(phase, cfg, pilot)))
    assert H.OUT_DIR == train_converge.OUT_DIR == train_smoke.OUT_DIR == out
    for p in paths:
        assert os.path.dirname(p) == out, p
    jax_outputs = {os.path.realpath(os.path.join(REPO, n))
                   for n in jax_names}
    assert not {os.path.realpath(p) for p in paths} & jax_outputs
    # the JAX runs' committed reports stay where they are
    assert os.path.exists(os.path.join(REPO, "CONVERGE_GLOBAL.md"))
    assert not os.path.exists(os.path.join(out, "TRAIN_CONVERGE_TPU.md"))
    assert H.CORPUS_ROOT != "/tmp/akx_hard_corpus"
    assert os.path.basename(H.CORPUS_ROOT) == "akx_hard_corpus_torch"


@pytest.mark.parametrize("harness", ["train_converge_hard", "train_converge",
                                     "train_smoke"])
def test_training_harnesses_refuse_cuda_without_cuda(harness, tmp_path):
    """Each training harness runs on the card by default; without CUDA it
    raises (naming CUDA) before it writes anything."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    out = str(tmp_path / "out")
    run = {"train_converge_hard": lambda: H.run_phase(
               "global", True, corpus_root=str(tmp_path / "c"), out_dir=out),
           "train_converge": lambda: train_converge.main(out_dir=out),
           "train_smoke": lambda: train_smoke.main(out_dir=out)}[harness]
    with pytest.raises(RuntimeError, match="CUDA"):
        run()
    with pytest.raises(RuntimeError, match="CUDA"):
        H.main(["global", "--pilot"])
    assert not os.listdir(tmp_path)


def test_run_phase_refuses_an_unknown_phase(tmp_path):
    with pytest.raises(ValueError, match="phase"):
        H.run_phase("glob", device="cpu", corpus_root=str(tmp_path))
