"""PyTorch port: Trainer.fit and the train/eval CLIs at world 2 on the
CPU (gloo ranks spawned on a file:// store, tests/torch_dp_workers.py),
against the same runs in one process.

 * fit for 2 epochs with the epoch -1 evaluation: every rank's history
   is identical (epochs, losses, validation aggregates) and within the
   world-1 run's: losses and val metrics rtol 1e-3 (two steps of Adam
   from the same weights; the float32 sums of the two layouts differ in
   order, and a gradient at the rounding floor may flip an update of
   ~lr); rank 0 alone calls the metrics writer and writes
   best_model.pt / last_state.pt / config.json;
 * a run stopped after 1 of 2 epochs and resumed at world 2 ends with the
   uninterrupted world-2 run's weights and step;
 * an early stop (patience 1, lr 0: the validation loss moves only with
   the BatchNorm statistics) fires at the same epoch on every rank and in
   the world-1 run;
 * cli/train.py --debug (batch 2 x acc_grad 1: one row a rank) at
   tests/test_cli.py:123-140's tiny geometry writes one run directory
   (version_0) and one tuning row, rank 0 writing the feature cache the
   other rank reads; cli/eval.py reads the run back;
 * Trainer(use_mesh=False) under the group raises on every rank (each
   rank would train alone and write the one run directory).
"""

import csv
import os

import numpy as np
import pytest

from audio_key_estimation_torch.config import Config
from audio_key_estimation_torch.data import synthetic

import torch_dp_workers as W

CFG = Config(octaves=4, num_layers=2, conv_layers=1, n_filters=2,
             kernel_size=3, head_layers=1, bucket_sizes=(32,), batch_size=4,
             acc_grad=2, frames=5, epochs=2, early_stop_patience=5)
STOP = CFG.replace(lr=0.0, early_stop_patience=1, epochs=6)
N_TRAIN, N_VAL = 16, 6
ARCH = ["--octaves", "4", "--num_layers", "2", "--conv_layers", "1",
        "--n_filters", "2", "--kernel_size", "3", "--head_layers", "1",
        "--bucket_sizes", "32"]


def _mtg_corpus(root):
    keys = ["c major", "a minor", "g major", "d major", "e minor", "f major"]
    songs = [(f"m{i}", 220.0 * 2 ** (i / 6), keys[i % 6], "techno")
             for i in range(6)]
    return synthetic.make_giantsteps_corpus(
        os.path.join(root, "giantsteps-mtg-key-dataset"), songs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each world-2 rank's results for the full fit, the partial fit and
    its resume, the early stop and the CLIs; the world-1 fits run here
    while the ranks work."""
    root = tmp_path_factory.mktemp("fit")
    _mtg_corpus(str(root))
    args = ["--debug", "--epochs", "2", "--data_root", str(root),
            "--log_dir", str(root / "Model_logs"), "--no_test", "--device",
            "cpu"] + ARCH
    jobs = [(W.dp_fit, (CFG, str(root / "full"), N_TRAIN, N_VAL, False,
                        True)),
            (W.dp_fit, (CFG.replace(epochs=1), str(root / "part"), N_TRAIN,
                        N_VAL)),
            (W.dp_fit, (CFG, str(root / "part"), N_TRAIN, N_VAL, True)),
            (W.dp_fit, (STOP, str(root / "stop"), N_TRAIN, N_VAL)),
            (W.dp_cli, (str(root), args, args + ["--version", "0"])),
            (W.dp_fit_without_mesh, (CFG,))]
    ranks = W.Ranks(W.run_jobs, 2, root, jobs)
    one = {"full": W.dp_fit(CFG, str(root / "one_full"), N_TRAIN, N_VAL,
                            False, True),
           "stop": W.dp_fit(STOP, str(root / "one_stop"), N_TRAIN, N_VAL)}
    res = ranks.results()
    return root, one, [dict(zip(("full", "part", "resumed", "stop", "cli",
                                 "no_mesh"), r)) for r in res]


def _same_history(a, b, rtol):
    assert [r["epoch"] for r in a] == [r["epoch"] for r in b]
    for ra, rb in zip(a, b):
        assert ra.keys() == rb.keys()
        for k in ra:
            if k != "epoch_seconds":
                np.testing.assert_allclose(ra[k], rb[k], rtol=rtol,
                                           atol=rtol, err_msg=k)


def test_every_rank_has_the_same_history(runs):
    _, _, ranks = runs
    for case in ("full", "resumed", "stop"):
        _same_history(ranks[1][case]["history"], ranks[0][case]["history"],
                      0)
        for k, v in ranks[0][case]["weights"].items():
            np.testing.assert_array_equal(ranks[1][case]["weights"][k], v)


def test_history_within_the_single_process_run(runs):
    _, one, ranks = runs
    assert [r["epoch"] for r in ranks[0]["full"]["history"]] == [-1, 0, 1]
    _same_history(ranks[0]["full"]["history"], one["full"]["history"], 1e-3)
    assert ranks[0]["full"]["step"] == one["full"]["step"] == 2 * (16 // 8)


def test_rank_zero_alone_writes(runs):
    """rank 0 calls the metrics writer and saves the checkpoints; both
    ranks see best_model.pt, last_state.pt and config.json once fit
    returns."""
    _, _, ranks = runs
    r0, r1 = ranks[0]["full"], ranks[1]["full"]
    assert len(r0["written_rows"]) == len(r0["history"]) == 3
    assert r1["written_rows"] == [] and r1["saves"] == []
    assert r0["saves"].count("save_train_state") == 2
    assert r0["saves"].count("save") >= 1
    for r in (r0, r1):
        assert {"best_model.pt", "last_state.pt", "config.json"} <= set(
            r["files"])


def test_resume_at_world_two(runs):
    """1 epoch, then resumed for the second: the weights and step of the
    uninterrupted run, and the resumed history is epoch 1 alone."""
    _, _, ranks = runs
    for r in ranks:
        assert [h["epoch"] for h in r["resumed"]["history"]] == [1]
        assert r["resumed"]["step"] == r["full"]["step"]
        for k, v in r["full"]["weights"].items():
            np.testing.assert_array_equal(r["resumed"]["weights"][k], v,
                                          err_msg=k)


def test_early_stop_fires_at_the_same_epoch(runs):
    _, one, ranks = runs
    epochs = [[h["epoch"] for h in r["stop"]["history"]] for r in ranks]
    want = [h["epoch"] for h in one["stop"]["history"]]
    assert epochs[0] == epochs[1] == want
    assert len(want) < STOP.epochs


def test_train_and_eval_cli_at_world_two(runs):
    """One run directory for both ranks, one tuning row; the eval CLI
    reads the run back on both ranks."""
    root, _, ranks = runs
    runs_dir = root / "Model_logs" / "lightning_logs"
    assert sorted(os.listdir(runs_dir)) == ["version_0"]
    assert {"best_model.pt", "last_state.pt", "config.json",
            "metrics.csv"} <= set(os.listdir(runs_dir / "version_0"))
    with open(root / "Tuning_results_Experiment_1.csv") as f:
        assert len(list(csv.reader(f))) == 2
    for r in ranks:
        assert "mirex" in r["cli"]["val"] and r["cli"]["eval"] == {}
    assert ranks[0]["cli"]["val"] == ranks[1]["cli"]["val"]
    cached = [n for n in os.listdir(root / "giantsteps-mtg-key-dataset"
                                    / "audio") if n.endswith(".npz")]
    assert cached


def test_single_device_trainer_is_refused_under_a_group(runs):
    _, _, ranks = runs
    for r in ranks:
        assert "use_mesh=False" in r["no_mesh"] and "2 ranks" in r["no_mesh"]
