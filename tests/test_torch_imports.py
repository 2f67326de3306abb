"""PyTorch port: import hygiene, device handling, and the copied constants.

The port (audio_key_estimation_torch) must import no JAX and nothing of
the reference package, refuse a CUDA device it cannot have, and carry
bit-exact copies of what it takes from the reference package: the
`Config` and its helpers, the key-signature map, the host constants, and
the files it carries byte for byte (the MP3 decoder and its tables, the
loaders, labels, synthetic corpora, the blacklist and the C++ audio
library's sources).
"""

import argparse
import ast
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from dataclasses import astuple

import numpy as np
import pytest
import torch

from audio_key_estimation_tpu import config as jax_config
from audio_key_estimation_tpu.config import Config
from audio_key_estimation_tpu.data import audio_io as jax_audio_io
from audio_key_estimation_tpu.data.loaders import A_GENRES
from audio_key_estimation_tpu.models import schedule as jax_schedule
from audio_key_estimation_tpu.ops import cqt as jax_cqt
from audio_key_estimation_tpu.ops import cqt_pallas as jax_cqt_pallas
from audio_key_estimation_tpu.utils import key_signatures as jax_keysig

from audio_key_estimation_torch import config as port_config
from audio_key_estimation_torch.data import audio_io
from audio_key_estimation_torch.data.loaders import A_GENRES as PORT_GENRES
from audio_key_estimation_torch.models import schedule
from audio_key_estimation_torch.ops import convstack_cuda, cqt, cqt_cuda
from audio_key_estimation_torch.ops.frontend import use_cuda_kernels
from audio_key_estimation_torch.predict import KeyEstimator
from audio_key_estimation_torch.utils import key_signatures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALLOWED_TPU_MODULES = set()   # the port imports nothing of the JAX package

TINY = dict(octaves=3, num_layers=2, conv_layers=1, n_filters=2,
            kernel_size=3, head_layers=1)


def test_port_serves_without_jax(tmp_path):
    """Import the port (its CLI, dataset, host library binding and probe
    entry points included), serve one tiny WAV and import a two-song
    corpus on the CPU in a fresh interpreter: no jax/flax module and no
    module of the JAX package may load."""
    code = textwrap.dedent(f"""
        import json, sys
        import numpy as np
        import audio_key_estimation_torch
        from audio_key_estimation_torch.cli import predict as cli
        from audio_key_estimation_torch.config import Config
        from audio_key_estimation_torch.data import audio_io
        from audio_key_estimation_torch.models import PitchClassNet
        from audio_key_estimation_torch.ops import cqt_cuda, convstack_cuda
        from audio_key_estimation_torch.ops import probes_cuda
        from audio_key_estimation_torch.predict import KeyEstimator
        from audio_key_estimation_torch.scripts import (
            experiment_transpose_kernel, harness, probe_cqt_kernel_stages,
            probe_dma_rate, probe_pallas_overhead, probe_pallas_primitives,
            profile_cqt_frontend)
        from audio_key_estimation_torch.cli import datasets
        from audio_key_estimation_torch.data import loaders, synthetic
        from audio_key_estimation_torch.data.dataset import KeyDataset
        from audio_key_estimation_torch.native import binding
        cfg = Config(**{TINY!r})
        wav = {str(tmp_path / "a.wav")!r}
        t = np.arange(8000 * 2) / 8000
        audio_io.write_wav(wav, 0.3 * np.sin(2 * np.pi * 330 * t), 8000)
        est = KeyEstimator(cfg, PitchClassNet(cfg).state_dict(),
                           device="cpu", bucket_seconds=(3,))
        pred = est.predict_files([wav], return_raw=True)[0]
        assert np.isfinite(pred.key_probs).all(), pred
        root = synthetic.make_giantsteps_corpus(
            {str(tmp_path / "gs")!r}, [("a", 261.6, "C major", "techno"),
                                       ("b", 440.0, "A minor", "pop rock")])
        ds = KeyDataset(True, cfg, use_cache=False, device="cpu")
        ds.import_data(loaders.GiantStepsKeyLoader(root), progress=False)
        batch = next(ds.batches(2))
        assert batch["mel"].shape[:2] == (2, cfg.pitches), batch["mel"].shape
        assert np.isfinite(batch["mel"]).all() and batch["valid"].all()
        print(json.dumps({{"mods": sorted(sys.modules), "key": pred.key}}))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    import json
    mods = json.loads(res.stdout.strip().splitlines()[-1])["mods"]
    assert "jax" not in mods and "flax" not in mods
    assert not [m for m in mods if m.startswith(("jax.", "flax.", "jaxlib"))]
    tpu = {m for m in mods if m.startswith("audio_key_estimation_tpu")}
    assert tpu <= ALLOWED_TPU_MODULES, tpu - ALLOWED_TPU_MODULES


def test_training_entry_points_import_no_jax():
    """Importing the train, eval and equivariance CLIs (and with them the
    trainer, loss, metrics, optimizer, checkpoints, prefetch and logging),
    the data-parallel mesh, the profiling helpers, the scraper and its
    CLI, and the tests' data-parallel worker module (which spawned ranks
    import without the tests' conftest) in a fresh interpreter loads no
    jax, flax, optax or orbax module and no module of the JAX package."""
    code = textwrap.dedent("""
        import json, sys
        from audio_key_estimation_torch.cli import equivariance, eval, train
        from audio_key_estimation_torch.train import (checkpoints, loss,
                                                      metrics, optim, trainer)
        from audio_key_estimation_torch import parallel
        from audio_key_estimation_torch.parallel import mesh
        from audio_key_estimation_torch.utils import profiling
        from audio_key_estimation_torch.scrape import song_lists, youtube
        from audio_key_estimation_torch.cli import scrape
        import torch_dp_workers
        print(json.dumps(sorted(sys.modules)))
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.path.join(REPO, "tests")]))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    mods = json.loads(res.stdout.strip().splitlines()[-1])
    assert {"audio_key_estimation_torch.train.trainer",
            "audio_key_estimation_torch.parallel.mesh",
            "audio_key_estimation_torch.utils.profiling",
            "audio_key_estimation_torch.scrape.youtube",
            "torch_dp_workers"} <= set(mods)
    bad = [m for m in mods if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "optax", "orbax", "audio_key_estimation_tpu")]
    assert not bad, bad


def test_bench_and_serving_loop_import_no_jax():
    """The port's bench and serving loop load, in a fresh interpreter, no
    jax, flax, optax or orbax module, no module of the JAX package and
    not the repository's root bench.py (module `bench`)."""
    code = textwrap.dedent("""
        import json, sys
        from audio_key_estimation_torch import bench
        from audio_key_estimation_torch.scripts import serving_loop
        print(json.dumps(sorted(sys.modules)))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    mods = json.loads(res.stdout.strip().splitlines()[-1])
    assert {"audio_key_estimation_torch.bench",
            "audio_key_estimation_torch.scripts.serving_loop"} <= set(mods)
    bad = [m for m in mods if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "optax", "orbax", "audio_key_estimation_tpu",
        "bench")]
    assert not bad, bad


def test_convergence_harnesses_import_no_jax():
    """The port's convergence harnesses (train_converge_hard,
    train_converge, train_smoke, local_ceiling_analysis) load, in a fresh
    interpreter, no jax, flax, optax or orbax module, no module of the
    JAX package and none of the repository's root `scripts/`."""
    code = textwrap.dedent("""
        import json, sys
        from audio_key_estimation_torch.scripts import (
            local_ceiling_analysis, train_converge, train_converge_hard,
            train_smoke)
        print(json.dumps(sorted(sys.modules)))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    mods = json.loads(res.stdout.strip().splitlines()[-1])
    assert {f"audio_key_estimation_torch.scripts.{n}" for n in (
        "local_ceiling_analysis", "train_converge",
        "train_converge_hard", "train_smoke")} <= set(mods)
    bad = [m for m in mods if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "optax", "orbax", "audio_key_estimation_tpu",
        "scripts", "bench")]
    assert not bad, bad


def test_render_pool_workers_load_no_torch():
    """data/render_pool.py, the entry module whose spawned workers render
    the hard benchmark's songs, loads in a fresh interpreter numpy and the
    synthetic writer and no torch, no JAX and no training harness: each
    worker re-imports it."""
    code = textwrap.dedent("""
        import json, sys
        import audio_key_estimation_torch.data.render_pool
        print(json.dumps(sorted(sys.modules)))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    mods = json.loads(res.stdout.strip().splitlines()[-1])
    assert {"numpy", "audio_key_estimation_torch.data.synthetic"} <= set(mods)
    bad = [m for m in mods if m.split(".")[0] in (
        "torch", "jax", "jaxlib", "flax", "audio_key_estimation_tpu")
        or m.startswith("audio_key_estimation_torch.scripts")]
    assert not bad, bad


def _imported_modules(path: str) -> set:
    """Every module an import statement of the file names."""
    mods = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    return mods


def _imported_names(path: str) -> set:
    """The last part of every module an import statement of the file
    names, and every name a `from` import takes: `from .ops.cqt_oracle
    import f` and `from .ops import cqt_oracle` both give cqt_oracle."""
    return {m.rsplit(".", 1)[-1] for m in _imported_modules(path)} | {
        a.name for node in ast.walk(ast.parse(open(path).read()))
        if isinstance(node, ast.ImportFrom) for a in node.names}


def _port_sources() -> list:
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tests", "torch_dp_workers.py")]
    for root, dirs, names in os.walk(os.path.join(
            REPO, "audio_key_estimation_torch")):
        dirs[:] = [d for d in dirs if d not in ("_build", "__pycache__")]
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_sources_import_no_jax_package(path):
    """No import statement of the port, of chip_smoke.py or of the tests'
    data-parallel worker module names the JAX package, jax, flax, optax,
    orbax or the repository's root bench.py (comments and strings may
    name a counterpart)."""
    bad = {m for m in _imported_modules(path)
           if m.split(".")[0] in ("audio_key_estimation_tpu", "jax", "jaxlib",
                                  "flax", "optax", "orbax", "bench")}
    assert not bad, bad


ORACLES = ("audio_key_estimation_torch.ops.cqt_oracle",
           "audio_key_estimation_torch.ops.librosa_ref")


def test_product_modules_never_import_the_oracles():
    """The CQT oracles (ops/cqt_oracle.py, ops/librosa_ref.py) are
    test-only: no module of the port but the two names them in an import
    statement (chip_smoke.py and the tests may), and importing serving,
    the dataset, the trainer, the CLIs and the bench in a fresh
    interpreter loads neither."""
    package = os.path.join(REPO, "audio_key_estimation_torch")
    sources = [f for f in _port_sources() if f.startswith(package)]
    assert {os.path.join(REPO, *m.split(".")) + ".py" for m in ORACLES} \
        <= set(sources)
    for path in sources:
        if path.endswith(("cqt_oracle.py", "librosa_ref.py")):
            continue
        assert not ({"cqt_oracle", "librosa_ref"} & _imported_names(path)), \
            path
    code = textwrap.dedent("""
        import json, sys
        from audio_key_estimation_torch import bench, predict
        from audio_key_estimation_torch.data import dataset
        from audio_key_estimation_torch.train import trainer
        from audio_key_estimation_torch.cli import (datasets, equivariance,
                                                    eval, predict as cli,
                                                    train)
        print(json.dumps(sorted(sys.modules)))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    mods = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert {"audio_key_estimation_torch.predict",
            "audio_key_estimation_torch.data.dataset"} <= mods
    assert not mods & set(ORACLES), mods & set(ORACLES)


def test_one_module_owns_the_stack_kernels():
    """ops/stack_kernels.py is the only module of the package that
    imports every stack-kernel wrapper (convstack_cuda, resstack_cuda,
    pcstack_cuda); no module under models/ imports any, and no wrapper
    imports another or stack_kernels."""
    package = os.path.join(REPO, "audio_key_estimation_torch")
    wrappers = {"convstack_cuda", "resstack_cuda", "pcstack_cuda"}
    both = []
    for path in _port_sources():
        if not path.startswith(package):
            continue
        rel = os.path.relpath(path, package)
        names = _imported_names(path)
        if wrappers <= names:
            both.append(rel)
        if rel.startswith("models"):
            assert not names & wrappers, rel
        if rel in (os.path.join("ops", w + ".py") for w in wrappers):
            assert not names & (wrappers | {"stack_kernels"}), rel
    assert both == [os.path.join("ops", "stack_kernels.py")]


def test_config_fields_and_defaults_equal():
    ours = [(f.name, f.type, f.default) for f in
            dataclasses.fields(port_config.Config)]
    ref = [(f.name, f.type, f.default) for f in dataclasses.fields(Config)]
    assert ours == ref
    assert port_config.RUNTIME_FIELDS == jax_config.RUNTIME_FIELDS
    cfg = port_config.Config(only_semitones=True, octaves=6)
    assert (cfg.bins_per_octave, cfg.pitches, cfg.pitch_classes) == (12, 72,
                                                                     12)
    assert not hasattr(port_config.Config, "pallas_cqt_enabled")


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_config_json_round_trip(direction):
    """A config.json written by either package loads in the other."""
    kw = dict(octaves=6, mesh_shape=(4,), bucket_sizes=(64, 128),
              use_pallas_cqt="off", fused_convstack=True, lr=1e-3)
    src, dst = ((Config, port_config.Config) if direction == "jax_to_port"
                else (port_config.Config, Config))
    text = src(**kw).to_json()
    got = dst.from_json(text)
    assert isinstance(got, dst) and got.to_json() == text
    assert dataclasses.asdict(got) == dataclasses.asdict(src(**kw))
    assert dst.from_json(json.dumps({**json.loads(text), "gone": 1})) == got


def test_config_helpers_equal():
    """add_config_args: the same flags with the same defaults; parsing
    the same command line gives equal configs; merge_eval_config agrees."""
    def parser_of(mod):
        p = argparse.ArgumentParser()
        mod.add_config_args(p)
        return p
    ours, ref = parser_of(port_config), parser_of(jax_config)
    flags = lambda p: [(a.option_strings, a.default, a.const, a.choices,
                        a.nargs) for a in p._actions]
    assert flags(ours) == flags(ref)
    argv = ["--octaves", "5", "--mesh_shape", "2,2", "--use_pallas_cqt",
            "--genre", "--lr", "0.01"]
    a = port_config.config_from_args(ours.parse_args(argv))
    b = jax_config.config_from_args(ref.parse_args(argv))
    assert a.to_json() == b.to_json()
    cli, saved = Config(data_root="x", octaves=3), Config(octaves=7,
                                                          data_root="y")
    pc, ps = (port_config.Config.from_json(c.to_json()) for c in (cli, saved))
    assert (port_config.merge_eval_config(pc, ps).to_json()
            == jax_config.merge_eval_config(cli, saved).to_json())


def test_key_signature_map_equal():
    np.testing.assert_array_equal(key_signatures.KEY_SIGNATURE_MAP,
                                  jax_keysig.KEY_SIGNATURE_MAP)
    assert key_signatures.KEY_SIGNATURE_MAP.dtype == np.float32
    assert key_signatures.NUM_SIGNATURE_ROWS == jax_keysig.NUM_SIGNATURE_ROWS


@pytest.mark.parametrize("device", [{"device": "cuda"}, {}],
                         ids=["cuda", "default"])
def test_cuda_device_refused_without_cuda(device):
    """KeyEstimator serves on the card by default; without CUDA it raises
    unless the CPU was asked for."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    from audio_key_estimation_torch.models import PitchClassNet
    cfg = Config(**TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        KeyEstimator(cfg, PitchClassNet(cfg).state_dict(), **device)


@pytest.mark.parametrize("entry", ["dataset", "train_val", "test_sets"])
def test_dataset_refuses_cuda_without_cuda(entry, tmp_path):
    """KeyDataset and the cli.datasets builders compute on the card by
    default; without CUDA they raise unless the CPU was asked for."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    from audio_key_estimation_torch.cli import datasets
    from audio_key_estimation_torch.data.dataset import KeyDataset
    cfg = port_config.Config(data_root=str(tmp_path), debug=True)
    build = {"dataset": lambda **kw: KeyDataset(False, cfg, **kw),
             "train_val": lambda **kw: datasets.build_train_val(cfg, **kw),
             "test_sets": lambda **kw: datasets.build_test_sets(cfg, **kw)
             }[entry]
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA"):
            build(**kw)
    assert build(device="cpu") is not None


COPIES = [f"data/{n}" for n in (
    "mp3.py", "_mp3_tables.py", "_mp3_tables_lsf.py", "_mp3_synth.py",
    "_mp3_bands_lsf.py", "loaders.py", "synthetic.py", "short_songs.txt",
    "pipeline.py")] \
    + ["utils/labels.py", "utils/logging.py"] + [f"native/{n}" for n in (
        "akx_native.cpp", "akx_mp3.cpp", "akx_decoded.h", "akx_mp3_tables.h")]\
    + [f"scrape/{n}" for n in ("__init__.py", "youtube.py", "song_lists.py")]\
    + ["cli/scrape.py"]


# copies that carry the port's tracer: each (original, port's) text once
TRACED = {"data/pipeline.py": [
    ("from typing import Iterable, Iterator\n",
     "from typing import Iterable, Iterator\n\n"
     "from ..utils.profiling import span\n"),
    ("            item = q.get()\n",
     "            with span(\"akx.feed_wait\"):\n"
     "                item = q.get()\n")]}


@pytest.mark.parametrize("rel", COPIES)
def test_byte_copies_equal(rel):
    """Each file the port carries unchanged equals its original byte for
    byte; one that carries the tracer's spans (TRACED) equals its
    original with those spans added and nothing else."""
    ours = os.path.join(REPO, "audio_key_estimation_torch", rel)
    ref = os.path.join(REPO, "audio_key_estimation_tpu", rel)
    want = open(ref, "rb").read()
    for old, new in TRACED.get(rel, ()):
        assert want.count(old.encode()) == 1, old
        want = want.replace(old.encode(), new.encode())
    assert open(ours, "rb").read() == want


def test_kernel_wrappers_never_fall_back_off_cpu():
    """A tensor that is neither on the CPU nor on a CUDA device must not
    reach a plain version: each wrapper raises."""
    m = torch.empty(2, 4096, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError):
        cqt_cuda.cascade_pad(m, 256, 3000, 1500,
                             torch.empty(2, 2024, device="meta"),
                             cqt.halfband_taps())
    bank = cqt_cuda.Bank(*(torch.empty(72, 512, device="meta"),) * 3)
    with pytest.raises(ValueError):
        cqt_cuda.octave_response(m, torch.empty(2, 6000, device="meta"),
                                 cqt_cuda.arena_layout(3000, 8, 512),
                                 torch.zeros(8, 5, dtype=torch.int32),
                                 bank, torch.empty(8, 36, device="meta"),
                                 torch.empty(2, 288, 5, device="meta"))
    x = torch.empty(1, 8, 8, 8, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        convstack_cuda.conv7_layer(
            x, torch.empty(convstack_cuda.PACKED, dtype=torch.bfloat16,
                           device="meta"),
            torch.empty(8, device="meta"))
    assert cqt_cuda.cascade_pad.launches == 0
    assert convstack_cuda.conv7_layer.launches == 0


def test_use_pallas_cqt_resolution():
    cpu, gpu = torch.device("cpu"), torch.device("cuda")
    assert use_cuda_kernels("auto", cpu) is False
    assert use_cuda_kernels("auto", gpu) is True
    assert use_cuda_kernels("off", gpu) is False
    assert use_cuda_kernels(True, gpu) is True
    with pytest.raises(ValueError, match="CUDA"):
        use_cuda_kernels("on", cpu)
    with pytest.raises(ValueError):
        use_cuda_kernels("sometimes", gpu)


@pytest.mark.parametrize("sr,hop,bpo,octaves", [
    (22050, 4410, 36, 8), (22050, 4410, 12, 8), (8000, 1600, 12, 3),
    (44100, 8820, 36, 7), (22050, 4410, 36, 4)])
def test_cqt_constants_bit_equal(sr, hop, bpo, octaves):
    pj = jax_cqt.CQTParams(sr=sr, hop=hop, bins_per_octave=bpo,
                           octaves=octaves)
    pt = cqt.CQTParams(sr=sr, hop=hop, bins_per_octave=bpo, octaves=octaves)
    bj, bt = jax_cqt.kernel_bank(pj), cqt.kernel_bank(pt)
    assert bj["n_fft"] == bt["n_fft"]
    for k in ("k_cos", "k_sin", "scales"):
        assert bj[k].dtype == bt[k].dtype
        np.testing.assert_array_equal(bj[k], bt[k])
    for o in range(octaves):
        assert (jax_cqt_pallas._frame_starts(hop, o, 900)
                == cqt._frame_starts(hop, o, 900))


def test_halfband_and_poly_matrix_bit_equal():
    np.testing.assert_array_equal(jax_cqt.halfband_taps(),
                                  cqt.halfband_taps())
    np.testing.assert_array_equal(jax_cqt.halfband_taps(33),
                                  cqt.halfband_taps(33))
    np.testing.assert_array_equal(jax_cqt._poly_matrix(), cqt._poly_matrix())
    scaled = cqt.halfband_taps() * np.float32(1 / 32768.0)
    np.testing.assert_array_equal(jax_cqt._poly_matrix(scaled),
                                  cqt._poly_matrix(scaled))
    # the polyphase matrix is the direct FIR the port's kernel A computes
    w = cqt._poly_matrix()
    taps = cqt.halfband_taps()
    for m in (0, 7, 127):
        np.testing.assert_array_equal(w[2 * m:2 * m + 49, m], taps)


def test_reference_hop_and_genres_equal():
    for sr in (8000, 16000, 22050, 44100):
        for frames in (1, 5, 10):
            assert (jax_cqt.reference_hop(sr, frames)
                    == cqt.reference_hop(sr, frames))
        assert (jax_cqt.reference_hop(sr, 0, 592, 123457)
                == cqt.reference_hop(sr, 0, 592, 123457))
    assert PORT_GENRES == A_GENRES and len(PORT_GENRES) == 11


def test_channel_schedule_equal():
    for nf in (1, 2, 4, 8):
        for cl in (1, 2, 3):
            for dense in (False, True):
                for layer in range(5):
                    assert (astuple(jax_schedule.layer_channels(
                        layer, nf, cl, dense)) == astuple(
                        schedule.layer_channels(layer, nf, cl, dense)))
                for nl in range(1, 6):
                    assert (jax_schedule.head_in_channels(nl, nf, cl, dense)
                            == schedule.head_in_channels(nl, nf, cl, dense))


def test_pcm16_io_matches_reference(tmp_path, rng):
    """write_wav / _wav_layout / _decode_wav_raw / pack_batch equal the
    JAX package's, and an MP3 decodes to the JAX package's samples."""
    y = (0.4 * rng.standard_normal(5001)).astype(np.float32)
    pa, pb = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    audio_io.write_wav(pa, y, 16000)
    jax_audio_io.write_wav(pb, y, 16000)
    assert open(pa, "rb").read() == open(pb, "rb").read()
    assert audio_io._wav_layout(pa) == jax_audio_io._wav_layout(pa)
    xa, sra = audio_io._decode_wav_raw(pa)
    xb, srb = jax_audio_io._decode_wav_raw(pa)
    assert sra == srb and xa.dtype == np.int16
    np.testing.assert_array_equal(xa, xb)
    xc, _ = audio_io.decode_audio(pa, raw=True)
    np.testing.assert_array_equal(xc, jax_audio_io.decode_audio(pa, raw=True)[0])
    fa = xa.astype(np.float32) / 32768.0
    waves = [xa, xa[:100]]
    np.testing.assert_array_equal(audio_io.pack_batch(waves, 6000, n_rows=3),
                                  jax_audio_io.pack_batch(waves, 6000,
                                                          n_rows=3))
    mixed = [xa, fa]
    np.testing.assert_array_equal(audio_io.pack_batch(mixed, 6000),
                                  jax_audio_io.pack_batch(mixed, 6000))
    got = list(audio_io.decode_many([pa, pa], raw=True))
    assert len(got) == 2 and got[1][1] == 16000 and got[1][0].dtype == np.int16
    # MP3 decodes as the JAX package decodes it
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import mp3_builder as B
    g = B.Granule(big_values=30, big_pairs=tuple(
        (int(a), int(b)) for a, b in rng.integers(-7, 8, (30, 2))),
        table_select=(10, 10, 10), global_gain=190)
    mp3 = tmp_path / "c.mp3"
    mp3.write_bytes(B.build_stream([B.build_frame([g, g])] * 3))
    ym, srm = audio_io.decode_audio(str(mp3), raw=True)
    yj, srj = jax_audio_io.decode_audio(str(mp3), raw=True)
    assert srm == srj == 44100 and ym.dtype == np.float32
    assert ym.shape == (3 * 1152,) and np.abs(ym).max() > 0
    np.testing.assert_array_equal(ym, yj)
