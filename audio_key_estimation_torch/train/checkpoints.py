"""Checkpoints with the serialized Config beside them.

The port's counterpart of the JAX package's train/checkpoints.py, with
torch files in place of orbax and msgpack. Run directories keep
Lightning's auto-versioning (Model_logs/lightning_logs/version_N):
  <log_dir>/version_<N>/best_model.pt     the model's state_dict
  <log_dir>/version_<N>/last_state.pt     model, optimizer, step, epoch,
                                          extra (mid-training resume)
  <log_dir>/version_<N>/config.json       the Config (either package's
                                          config.json loads in the other)
Files are read onto the CPU with torch.load(weights_only=True), whatever
device wrote them. A JAX run directory
(an orbax `best_model/` or `last_state.msgpack`) cannot be read here: it
raises, naming the conversion (models/convert.state_dict_from_jax, run in
a process that has JAX).
"""

from __future__ import annotations

import glob
import os
import re
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import Config

_FROM_JAX = ("is a JAX-package checkpoint; convert it in a process that "
             "has JAX: models.convert.state_dict_from_jax of its params and "
             "batch_stats, saved with torch.save")


def next_version_dir(log_dir: str) -> str:
    os.makedirs(log_dir, exist_ok=True)
    versions = []
    for d in glob.glob(os.path.join(log_dir, "version_*")):
        m = re.match(r".*version_(\d+)$", d)
        if m:
            versions.append(int(m.group(1)))
    v = max(versions) + 1 if versions else 0
    path = os.path.join(log_dir, f"version_{v}")
    os.makedirs(path, exist_ok=True)
    return path


def version_dir(log_dir: str, version: int) -> str:
    """Lightning-style run directory; version < 0 selects the latest one."""
    if version < 0:
        existing = sorted(
            (int(d.split("_", 1)[1]) for d in os.listdir(log_dir)
             if d.startswith("version_") and d.split("_", 1)[1].isdigit()),
        ) if os.path.isdir(log_dir) else []
        if not existing:
            raise FileNotFoundError(
                f"no version_N runs under {log_dir!r}; pass --version "
                "or train first")
        version = existing[-1]
    return os.path.join(log_dir, f"version_{version}")


def _write_config(run_dir: str, cfg: Config) -> None:
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())


def save(run_dir: str, model: torch.nn.Module, cfg: Config,
         name: str = "best_model") -> str:
    """Save the model's state_dict as run_dir/name.pt, config beside it."""
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(run_dir, name + ".pt"))
    torch.save(model.state_dict(), path)
    _write_config(run_dir, cfg)
    return path


def _read_config(run_dir: str) -> Optional[Config]:
    cfg_path = os.path.join(run_dir, "config.json")
    if not os.path.exists(cfg_path):
        return None
    with open(cfg_path) as f:
        return Config.from_json(f.read())


def load(run_dir: str, name: str = "best_model"
         ) -> Tuple[dict, Optional[Config]]:
    """Returns (state_dict of CPU tensors, Config or None)."""
    path = os.path.join(run_dir, name + ".pt")
    if not os.path.exists(path) and os.path.isdir(os.path.join(run_dir,
                                                               name)):
        raise ValueError(f"{os.path.join(run_dir, name)!r} {_FROM_JAX}")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd, _read_config(run_dir)


def save_train_state(run_dir: str, model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer, step: int,
                     cfg: Config, epoch: int, extra: Optional[dict] = None,
                     name: str = "last_state.pt") -> str:
    """Full-fidelity training snapshot (model, optimizer, step) for
    mid-training resume."""
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, name)
    torch.save({"model": model.state_dict(),
                "optimizer": optimizer.state_dict(),
                "step": int(step), "epoch": int(epoch),
                "extra": dict(extra or {})}, path)
    _write_config(run_dir, cfg)
    return path


def has_train_state(run_dir: str, name: str = "last_state.pt") -> bool:
    """Whether run_dir holds the port's resume snapshot; a JAX run's
    snapshot (last_state.msgpack) alone raises."""
    if os.path.exists(os.path.join(run_dir, name)):
        return True
    jax_state = os.path.join(run_dir, "last_state.msgpack")
    if os.path.exists(jax_state):
        raise ValueError(f"{jax_state!r} {_FROM_JAX}")
    return False


def load_train_state(run_dir: str, model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer,
                     name: str = "last_state.pt"):
    """Restore the snapshot into `model` and `optimizer` (on their
    devices); returns (step, epoch, extra)."""
    payload = torch.load(os.path.join(run_dir, name), map_location="cpu",
                         weights_only=True)
    model.load_state_dict(payload["model"])
    optimizer.load_state_dict(payload["optimizer"])
    return payload["step"], payload["epoch"], payload["extra"]


def load_torch_state_dict(path: str) -> dict:
    """Read a reference best_model.pt (torch state_dict) into numpy
    arrays."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: np.asarray(v.detach().numpy()) for k, v in sd.items()}
