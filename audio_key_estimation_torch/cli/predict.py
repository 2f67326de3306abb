"""Prediction CLI — the serving face of the port.

    python -m audio_key_estimation_torch.cli.predict song.wav ... \\
        --version N [--log_dir Model_logs] [--device cpu] [--local_windows]
    python -m audio_key_estimation_torch.cli.predict song.wav ... \\
        --torch_ckpt best_model.pt [config flags]

Prints, per input file, the estimated key (and genre when the model has a
genre head), or the per-window key timeline with --local_windows.
--version loads one of the port's training runs
(<log_dir>/lightning_logs/version_N, the latest when N < 0) with its own
config.json, which wins over the command line's architecture flags;
with --torch_ckpt those flags must match the checkpoint's training run.
Serves on the CUDA card; on a machine without one it raises unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
import os

from ..config import add_config_args, config_from_args
from ..predict import KeyEstimator
from ..train import checkpoints as ckpt_lib
from ..train.trainer import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Estimate musical key from audio files (PyTorch)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_config_args(parser)
    parser.add_argument("files", nargs="+", help="wav/mp3 files")
    parser.add_argument("--version", type=int, default=-1,
                        help="trained version number under --log_dir "
                             "(the latest when < 0)")
    parser.add_argument("--torch_ckpt", type=str, default="",
                        help="torch state_dict (reference best_model.pt or "
                             "an export of the port's / JAX package's "
                             "weights) in place of a training run")
    parser.add_argument("--device", type=str, default="cuda",
                        help="serve on this torch device; without CUDA "
                             "only --device cpu runs")
    parser.add_argument("--local_windows", action="store_true",
                        help="per-window key timeline (local mode)")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    resolve_device(args.device)   # without CUDA, refuse before any work
    if args.torch_ckpt:
        est = KeyEstimator.from_torch_checkpoint(args.torch_ckpt, cfg,
                                                 device=args.device)
    else:
        run_dir = ckpt_lib.version_dir(
            os.path.join(cfg.log_dir, "lightning_logs"), args.version)
        est = KeyEstimator.from_checkpoint(run_dir, device=args.device)
    results = {}
    if args.local_windows:
        for path, pred in zip(args.files,
                              est.predict_files_local(args.files)):
            print(path)
            for w in pred.windows:
                print(f"  {w.start:7.2f}-{w.end:7.2f}s  {w.key:24s} "
                      f"(conf {w.confidence:.3f})")
            results[path] = pred
    else:
        for path, pred in zip(args.files, est.predict_files(args.files)):
            genre = f"  genre={pred.genre}" if pred.genre else ""
            print(f"{path}: {pred.key}  (conf {pred.confidence:.3f}){genre}")
            results[path] = pred
    return results


if __name__ == "__main__":
    main()
