"""One short training run on the CUDA card.

The port of the JAX package's `scripts/train_smoke_tpu.py`: a synthetic
debug-slice corpus (16 two-minute songs), then the port's Trainer (the
code path of cli/train.py) for two epochs at batch 4 x acc_grad 2.
Records epoch losses and epoch seconds in converge_cuda/TRAIN_SMOKE.md
and raises on a non-finite loss:

    python -m audio_key_estimation_torch.scripts.train_smoke [--device cpu]

Without CUDA it raises unless the CPU is asked for (--device cpu).
"""
import argparse
import os
import sys
import tempfile
import time

import numpy as np

from ..config import Config
from ..data import loaders, synthetic
from ..data.dataset import KeyDataset
from ..train.trainer import Trainer, resolve_device
from .train_converge_hard import OUT_DIR, device_line


def main(device="cuda", out_dir: str = OUT_DIR, songs: int = 16,
         seconds: float = 120.0, **overrides) -> dict:
    """`songs`, `seconds` and Config `overrides` shrink a run for the
    tests. Returns the history and the report's path."""
    device = resolve_device(device)
    dev = device_line(device)
    print(f"training on {dev} ({device})", flush=True)

    cfg = Config(octaves=8, num_layers=2, conv_layers=3, n_filters=4,
                 kernel_size=7, head_layers=2, batch_size=4, acc_grad=2,
                 epochs=2, frames=5, bucket_sizes=(1024,), no_ckpt=True,
                 early_stop_patience=10,
                 fused_convstack=True).replace(**overrides)
    with tempfile.TemporaryDirectory() as td:
        keys = ["C major", "A minor", "G major", "D major"]
        corpus = [(f"s{i}", 220.0 * 2 ** (i / 12), keys[i % 4], "techno")
                  for i in range(songs)]
        root = synthetic.make_giantsteps_corpus(
            os.path.join(td, "gs"), corpus, seconds=seconds)
        t0 = time.time()
        ds = KeyDataset(genre=False, cfg=cfg, blacklist_path="",
                        use_cache=False, device=device)
        ds.import_data(loaders.GiantStepsKeyLoader(root), progress=False)
        prep_s = time.time() - t0
        print(f"preprocess (decode + CQT on {device}): {prep_s:.1f}s "
              f"for {len(ds)} songs", flush=True)

        trainer = Trainer(cfg, ds, ds, device=device, use_mesh=False)
        _, history = trainer.fit(seed=0)

    lines = [
        "# CUDA training smoke",
        "",
        f"Device: **{dev}** (`{device}`)",
        f"Config: flagship geometry (octaves={cfg.octaves}, "
        f"{cfg.num_layers} layers, conv_layers={cfg.conv_layers}, "
        f"n_filters={cfg.n_filters}, k={cfg.kernel_size}), batch "
        f"{cfg.batch_size} x acc_grad {cfg.acc_grad}, {len(ds)} "
        f"{seconds:.0f} s synthetic songs.",
        f"Preprocess (decode + batched CQT on `{device}`): {prep_s:.1f} s "
        f"({dev})",
        "",
        "| epoch | train_loss | val_loss | val_mirex | epoch_seconds |",
        "|---|---|---|---|---|",
    ]
    for row in history:
        lines.append(f"| {row['epoch']} | {row['train_loss']:.4f} | "
                     f"{row['val_loss']:.4f} | {row.get('val_mirex', 0):.4f}"
                     f" | {row['epoch_seconds']:.1f} |")
        if not np.isfinite(row["train_loss"]):
            raise FloatingPointError(f"epoch {row['epoch']}: train_loss "
                                     f"{row['train_loss']}")
    lines.append("")
    lines.append("Losses finite; the port's train step (grad-accum + Adam "
                 "+ BatchNorm carry) and validation ran on "
                 f"`{device}` ({dev}); epoch 0's seconds include the "
                 "first call's setup.")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "TRAIN_SMOKE.md")
    with open(out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {out}", flush=True)
    return {"history": history, "report": out, "prep_s": prep_s}


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without CUDA) or cpu")
    main(p.parse_args(sys.argv[1:]).device)
