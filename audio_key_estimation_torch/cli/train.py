"""Train CLI (reference train_model.py), on the CUDA card.

    python -m audio_key_estimation_torch.cli.train --data_root ../Data \\
        [--device cpu] [--resume_version N] [config flags]

Flags are the shared Config's (the JAX package's `cli/train.py` takes the
same), plus --device. Features are computed on the device (kernels A and
B on a card), the model trains there through autograd, and every
validation runs the eval-mode model (kernel C where its gate admits a
stack). Results land under <log_dir>/lightning_logs/version_N/
(best_model.pt, last_state.pt, config.json, metrics.csv); the final
validation runs the best checkpoint and appends a row to
Tuning_results_Experiment_1.csv in the working directory
(train_model.py:126-154). Without CUDA it raises unless --device cpu.

Data parallel over N cards, one process per card (the JAX package trains
over every device of its mesh):

    torchrun --nproc_per_node N -m audio_key_estimation_torch.cli.train \
        --data_root ../Data [--mesh_shape N] [config flags]

Each rank takes cuda:LOCAL_RANK (nccl; gloo with --device cpu) and its
rows of every micro-batch (--batch_size must divide over the ranks);
rank 0 alone prints and writes the run directory and the results.
"""

from __future__ import annotations

import argparse
import os

from ..config import add_config_args, config_from_args
from ..parallel.mesh import (broadcast_int, check_mesh_shape, data_world,
                             start_data_parallel)
from ..train import checkpoints as ckpt_lib
from ..train.trainer import Trainer, evaluate, resolve_device
from ..utils.logging import MetricsLogger, write_tuning_results
from .datasets import build_train_val


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; without CUDA only --device cpu "
                             "runs")


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="PitchClassNet training (PyTorch)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_config_args(parser)
    parser.add_argument("--resume_version", type=int, default=-1,
                        help="resume mid-training from this version dir")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    if cfg.debug:
        cfg = cfg.replace(batch_size=2, acc_grad=1)  # train_model.py:88-91
    device = start_data_parallel(resolve_device(args.device))
    rank, world = data_world()
    check_mesh_shape(cfg.mesh_shape, world)

    train_data, val_data = build_train_val(cfg, device=device)
    runs = os.path.join(cfg.log_dir, "lightning_logs")
    version = args.resume_version
    if version < 0:
        # one new run directory, made by rank 0
        if rank == 0:
            version = int(ckpt_lib.next_version_dir(runs).rsplit("_", 1)[1])
        if world > 1:
            version = broadcast_int(version)
    run_dir = ckpt_lib.version_dir(runs, version)
    logger = MetricsLogger(run_dir) if rank == 0 else None
    trainer = Trainer(cfg, train_data, val_data, log_dir=run_dir,
                      device=device)
    state, _ = trainer.fit(seed=cfg.seed, metrics_writer=logger,
                           resume=args.resume_version >= 0)

    # final validation with the best checkpoint (train_model.py:123-124)
    if not cfg.no_ckpt and os.path.exists(os.path.join(run_dir,
                                                       "best_model.pt")):
        best, _ = ckpt_lib.load(run_dir)
        state.model.load_state_dict(best)
    val = evaluate(trainer.eval_step, state, val_data, cfg.batch_size,
                   sharded=world > 1)
    if rank == 0:
        print({f"val_{k}": v for k, v in val.items()})
        write_tuning_results(os.path.join(
            os.getcwd(), "Tuning_results_Experiment_1.csv"), cfg, val)
        logger.close()
    return val


if __name__ == "__main__":
    main()
