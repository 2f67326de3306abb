"""PyTorch port: the train, eval, predict --version and equivariance
entry points on the CPU.

Mirrors tests/test_cli.py's train+eval and equivariance tests (slow-marked
there) with the port's CLIs at the tiny geometry, on a GiantSteps-MTG
corpus written by the port's data/synthetic.py: training writes its run
directory and tuning row, the eval CLI reproduces the train run's final
validation metrics exactly from the saved checkpoint and config.json
(deterministic CPU arithmetic, the same batches), predict --version
serves that run, and the equivariance stack on weights carried across
from the JAX model lies within 1e-4 of the JAX model's (the JAX CLI's own
atol).
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_key_estimation_tpu.cli import equivariance as jax_eq
from audio_key_estimation_tpu.config import Config as JaxConfig
from audio_key_estimation_tpu.data.audio_io import decode_audio
from audio_key_estimation_tpu.models import PitchClassNet as JaxNet
from audio_key_estimation_tpu.ops.cqt import CQTParams, cqt, reference_hop

from audio_key_estimation_torch.cli import equivariance as eq_cli
from audio_key_estimation_torch.cli import eval as eval_cli
from audio_key_estimation_torch.cli import predict as predict_cli
from audio_key_estimation_torch.cli import train as train_cli
from audio_key_estimation_torch.config import Config
from audio_key_estimation_torch.data import synthetic
from audio_key_estimation_torch.models.convert import state_dict_from_jax

ARCH = ["--octaves", "4", "--num_layers", "2", "--conv_layers", "1",
        "--n_filters", "2", "--kernel_size", "3", "--head_layers", "1"]
TINY = dict(octaves=4, num_layers=2, conv_layers=1, n_filters=2,
            kernel_size=3, head_layers=1)


def _mtg_corpus(tmp_path):
    keys = ["c major", "a minor", "g major", "d major", "e minor", "f major"]
    songs = [(f"m{i}", 220.0 * 2 ** (i / 6), keys[i % 6], "techno")
             for i in range(6)]
    return synthetic.make_giantsteps_corpus(
        str(tmp_path / "giantsteps-mtg-key-dataset"), songs)


def test_train_eval_and_predict_version_cli(tmp_path, monkeypatch):
    """--debug training (batch 2 x acc 1) for 2 epochs writes version_0
    with best_model.pt, last_state.pt, config.json and metrics.csv, and
    Tuning_results_Experiment_1.csv in the working directory; the eval CLI
    (--version 0, wrong architecture flags overridden by the saved
    config.json) gives the train run's final validation metrics exactly;
    predict --version serves the same run."""
    root = _mtg_corpus(tmp_path)
    monkeypatch.chdir(tmp_path)
    logs = tmp_path / "Model_logs"
    args = ["--debug", "--epochs", "2", "--data_root", str(tmp_path),
            "--log_dir", str(logs), *ARCH, "--bucket_sizes", "32",
            "--no_test", "--device", "cpu"]
    val = train_cli.main(args)
    assert "mirex" in val and val["num_samples"] == 4
    run = logs / "lightning_logs" / "version_0"
    assert {"best_model.pt", "last_state.pt", "config.json",
            "metrics.csv"} <= set(os.listdir(run))
    with open(tmp_path / "Tuning_results_Experiment_1.csv") as f:
        row = next(csv.DictReader(f))
    assert float(row["val_mirex"]) == pytest.approx(val["mirex"])
    assert row["effective_batch_size"] == "2"

    seen = []
    real = eval_cli.evaluate

    def recording(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]
    monkeypatch.setattr(eval_cli, "evaluate", recording)
    wrong = [a if a != "3" else "5" for a in args]     # kernel_size 5
    results = eval_cli.main(wrong + ["--version", "0", "--batch_size", "2"])
    assert results == {}          # no_test + debug: only validation
    assert seen == [val]

    audio = os.path.join(root, "audio")
    wavs = [os.path.join(audio, n) for n in sorted(os.listdir(audio))[:2]]
    preds = predict_cli.main(wavs + ["--version", "0", "--log_dir",
                                     str(logs), "--device", "cpu"])
    assert list(preds) == wavs and all(p.key for p in preds.values())


def test_predict_cli_needs_a_run_or_a_checkpoint(tmp_path):
    """Without --torch_ckpt, predict takes the latest version under
    --log_dir and raises when there is none."""
    with pytest.raises(FileNotFoundError, match="version_N"):
        predict_cli.main(["x.wav", "--log_dir", str(tmp_path),
                          "--device", "cpu"])


@pytest.mark.parametrize("entry", ["train", "eval", "equivariance",
                                   "predict"])
def test_clis_refuse_cuda_without_cuda(entry, tmp_path):
    """Every CLI runs on the card by default; without CUDA it raises
    before any work unless --device cpu is given."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    d = str(tmp_path)
    main, argv = {
        "train": (train_cli.main, ["--data_root", d, "--log_dir", d,
                                   "--debug"]),
        "eval": (eval_cli.main, ["--data_root", d, "--log_dir", d,
                                 "--debug"]),
        "equivariance": (eq_cli.main, ["--custom_cqt", "--save", ""]),
        "predict": (predict_cli.main, ["x.wav", "--log_dir", d]),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)


# ---------------------------------------------------------------------------
# equivariance
# ---------------------------------------------------------------------------

def _jax_stack(cfg, mel, seed=0):
    """The JAX model's 25 x 12 shift stack (jax_eq.shift_rows, the guard
    band, PRNGKey(seed) weights; init and apply jitted) and its
    variables."""
    guard = np.zeros((36, mel.shape[1]), mel.dtype)
    mel = np.concatenate([guard, mel, guard], axis=0)
    cfg = cfg.replace(octaves=mel.shape[0] // 36)
    model = JaxNet(cfg)
    x = np.stack([jax_eq.shift_rows(mel, s) for s in range(12, -13, -1)])
    variables = jax.jit(lambda k, x: model.init(k, x, None, False))(
        jax.random.PRNGKey(seed), jnp.asarray(x[:1, ..., None]))
    key = jax.jit(lambda v, x: model.apply(v, x, None, False)[0])(
        variables, jnp.asarray(x[..., None]))
    return np.asarray(key), jax.tree_util.tree_map(np.asarray, variables)


def test_equivariance_matches_jax_on_carried_weights():
    """The port's shift stack on the JAX model's weights (through
    state_dict_from_jax) lies within 1e-4 of the JAX stack, and both pass
    the equivariance check at 1e-4."""
    mel = synthetic.custom_cqt(2, with_border=False, frames_t=64)
    stack_j, variables = _jax_stack(JaxConfig(**TINY), mel)
    stack_t = eq_cli.shift_and_stack(Config(**TINY), mel,
                                     state_dict=state_dict_from_jax(
                                         variables), device="cpu")
    assert stack_t.shape == stack_j.shape == (25, 12)
    np.testing.assert_allclose(stack_t, stack_j, rtol=1e-4, atol=1e-4)
    assert eq_cli.check_equivariance(stack_t) < 1e-4
    assert jax_eq.check_equivariance(stack_j) < 1e-4
    for s in (3, 0, -5):
        np.testing.assert_array_equal(eq_cli.shift_rows(mel, s),
                                      jax_eq.shift_rows(mel, s))


def test_equivariance_cli_custom_and_wav(tmp_path):
    """The CLI passes on the blob CQT and on a scale WAV (the --wav route:
    the port's decode and CQT, within rtol/atol 1e-4 of the JAX
    package's float32 CQT of the same file), saving a 25 x 12 stack."""
    out = str(tmp_path / "eq.npy")
    assert eq_cli.main(["--custom_cqt", *ARCH, "--save", out,
                        "--device", "cpu"]) == 0
    assert np.load(out).shape == (25, 12)
    wav = str(tmp_path / "tone.wav")
    synthetic.scale_wav(wav, tonic_pc=0, minor=False, seconds=1.0)
    assert eq_cli.main(["--wav", wav, *ARCH, "--save", out,
                        "--device", "cpu"]) == 0
    cfg = Config(**TINY)
    ours = eq_cli.wav_cqt(wav, cfg, torch.device("cpu"))
    y, sr = decode_audio(wav)
    p = CQTParams(sr=sr, hop=reference_hop(sr, cfg.frames, cfg.window_size,
                                           len(y)),
                  bins_per_octave=36, octaves=cfg.octaves - 2)
    ref = np.asarray(cqt(jnp.asarray(y), p))[0]
    assert ours.shape == ref.shape == (72, ref.shape[1])
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)
