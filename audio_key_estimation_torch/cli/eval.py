"""Eval CLI (reference eval.py), on the CUDA card.

    python -m audio_key_estimation_torch.cli.eval --version N [--data_root ...]
    python -m audio_key_estimation_torch.cli.eval --torch_ckpt best_model.pt

Loads one of the port's run directories and its config.json (the saved
Config wins for the fields that define the model, the command line for
runtime fields: merge_eval_config), rebuilds the reference's validation
and test sets and prints the per-set MIREX breakdown. --torch_ckpt
evaluates a torch state_dict (a reference best_model.pt) with the
command line's architecture flags instead. Without CUDA it raises unless
--device cpu. Under torchrun (`torchrun --nproc_per_node N -m
audio_key_estimation_torch.cli.eval ...`) each rank evaluates its rows
of every batch, the sums are all-reduced and rank 0 prints.
"""

from __future__ import annotations

import argparse
import os

from ..config import (Config, add_config_args, config_from_args,
                      merge_eval_config)
from ..models.convert import load_state_dict
from ..parallel.mesh import check_mesh_shape, data_world, start_data_parallel
from ..train import checkpoints as ckpt_lib
from ..train.trainer import (TrainState, create_train_state, evaluate,
                             make_eval_step, resolve_device)
from .datasets import build_test_sets, build_train_val
from .train import add_device_arg


def load_state(cfg: Config, args, device) -> tuple[Config, TrainState]:
    if args.torch_ckpt:
        sd = ckpt_lib.load_torch_state_dict(args.torch_ckpt)
    else:
        run_dir = ckpt_lib.version_dir(
            os.path.join(cfg.log_dir, "lightning_logs"), args.version)
        sd, saved_cfg = ckpt_lib.load(run_dir)
        if saved_cfg is not None:
            cfg = merge_eval_config(cfg, saved_cfg)
    state = create_train_state(cfg, 0, device)
    load_state_dict(state.model, sd)
    return cfg, state


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="PitchClassNet evaluation (PyTorch)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_config_args(parser)
    parser.add_argument("--version", type=int, default=-1,
                        help="trained version number to evaluate")
    parser.add_argument("--torch_ckpt", type=str, default="",
                        help="evaluate a torch state_dict (reference "
                             "best_model.pt)")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = start_data_parallel(resolve_device(args.device))
    rank, world = data_world()
    cfg, state = load_state(config_from_args(args), args, device)
    check_mesh_shape(cfg.mesh_shape, world)
    eval_step = make_eval_step(cfg)
    say = print if rank == 0 else (lambda *a: None)

    _, val_data = build_train_val(cfg, device=device)
    say("Result of Validation set")
    say(evaluate(eval_step, state, val_data, max(cfg.batch_size, 1),
                 sharded=world > 1))
    results = {}
    if not cfg.no_test and not cfg.debug:
        for name, ds in build_test_sets(cfg, device=device).items():
            say(f"Result of {name} set")
            results[name] = evaluate(eval_step, state, ds,
                                     max(cfg.batch_size, 1),
                                     sharded=world > 1)
            say(results[name])
    return results


if __name__ == "__main__":
    main()
