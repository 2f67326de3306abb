"""Prediction CLI — the serving face of the port.

    python -m audio_key_estimation_torch.cli.predict song.wav ... \\
        --torch_ckpt best_model.pt [--device cpu] [config flags]

Prints, per input file, the estimated key (and genre when the model has a
genre head). Architecture flags must match the checkpoint's training run.
Serves on the CUDA card; on a machine without one it raises unless
`--device cpu` is given.
Loading a JAX-package run directory (orbax, --version) and the local
timeline are later port items (ROADMAP.md port queue items 6 and 2).
"""

from __future__ import annotations

import argparse

from ..config import add_config_args, config_from_args
from ..predict import KeyEstimator


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Estimate musical key from PCM16 WAV files (PyTorch)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_config_args(parser)
    parser.add_argument("files", nargs="+", help="PCM16 wav files")
    parser.add_argument("--torch_ckpt", type=str, required=True,
                        help="torch state_dict (reference best_model.pt or "
                             "an export of the port's / JAX package's "
                             "weights)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="serve on this torch device; without CUDA "
                             "only --device cpu runs")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    est = KeyEstimator.from_torch_checkpoint(args.torch_ckpt, cfg,
                                             device=args.device)
    results = {}
    for path, pred in zip(args.files, est.predict_files(args.files)):
        genre = f"  genre={pred.genre}" if pred.genre else ""
        print(f"{path}: {pred.key}  (conf {pred.confidence:.3f}){genre}")
        results[path] = pred
    return results


if __name__ == "__main__":
    main()
