"""Metrics logging: CSV rows + optional TensorBoard scalars.

Covers the reference's TensorBoardLogger + per-run hyperparameter/result CSV
(train_model.py:113,126-154; models.py:981-1004) without requiring
TensorBoard to be installed (tensorboardX is used when available).
"""

from __future__ import annotations

import csv
import os
from typing import Dict


class MetricsLogger:
    def __init__(self, run_dir: str, tensorboard: bool = True):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self.csv_path = os.path.join(run_dir, "metrics.csv")
        self._csv_fields = None
        self._tb = None
        if tensorboard:
            try:
                from tensorboardX import SummaryWriter
            except Exception:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                except Exception:
                    SummaryWriter = None
            if SummaryWriter is not None:
                try:
                    self._tb = SummaryWriter(run_dir)
                except Exception:
                    self._tb = None

    def __call__(self, row: Dict[str, float]):
        self.log_row(row)

    def log_row(self, row: Dict[str, float]):
        if self._csv_fields is None:
            self._csv_fields = list(row.keys())
            with open(self.csv_path, "w", newline="") as f:
                csv.DictWriter(f, self._csv_fields).writeheader()
        with open(self.csv_path, "a", newline="") as f:
            csv.DictWriter(f, self._csv_fields, extrasaction="ignore"
                           ).writerow(row)
        if self._tb is not None:
            step = int(row.get("epoch", 0))
            for k, v in row.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, step)

    def close(self):
        if self._tb is not None:
            self._tb.close()


def write_tuning_results(path: str, cfg, val_metrics: Dict[str, float]):
    """Hyperparameter+result row (train_model.py:126-154)."""
    row = {
        "val_acc": val_metrics.get("accuracy"),
        "val_acc_tonic": val_metrics.get("accuracy_tonic"),
        "val_acc_genre": val_metrics.get("accuracy_genre"),
        "val_loss": val_metrics.get("loss"),
        "val_mirex": val_metrics.get("mirex"),
        "val_correct": val_metrics.get("correct"),
        "val_fifths": val_metrics.get("fifths"),
        "val_relative": val_metrics.get("relative"),
        "val_parallel": val_metrics.get("parallel"),
        "val_other": val_metrics.get("other"),
        "lr": cfg.lr, "num_layers": cfg.num_layers,
        "kernel_size": cfg.kernel_size, "conv_layers": cfg.conv_layers,
        "n_filters": cfg.n_filters, "resblock": cfg.resblock,
        "denseblock": cfg.denseblock, "head_layers": cfg.head_layers,
        "effective_batch_size": cfg.batch_size * cfg.acc_grad,
        "tonic_loss_weight": cfg.tonic_weight,
        "genre_loss_weight": cfg.genre_weight,
        "time_pool_size": cfg.time_pool_size,
    }
    exists = os.path.exists(path)
    with open(path, "a" if exists else "w", newline="") as f:
        w = csv.DictWriter(f, list(row.keys()))
        if not exists:
            w.writeheader()
        w.writerow(row)
    return row
