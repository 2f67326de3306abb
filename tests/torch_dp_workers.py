"""Data-parallel ranks for the PyTorch port's tests, on the CPU with gloo.

`spawn_ranks(fn, world, tmp_path, *args)` (or `Ranks(...)`, which
returns at once, and its `results()`) starts `world` processes with the
spawn method, each joining a gloo process group through a file://
store under tmp_path (no TCP port, so concurrent test workers cannot
collide), runs fn(*args) on every rank and returns the ranks' results in
rank order. A rank that raises, exits non-zero or outlives the join
limit fails the call, naming the rank and its traceback.

The worker functions below run inside those processes. This module
imports only the standard library, numpy, torch and the port: a spawned
process imports it again, without the tests' conftest (no JAX there).
"""

from __future__ import annotations

import os
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

from audio_key_estimation_torch.config import Config
from audio_key_estimation_torch.data.dataset import KeyDataset
from audio_key_estimation_torch.parallel.mesh import (data_world,
                                                      init_data_parallel,
                                                      rank_rows)
from audio_key_estimation_torch.train import trainer
from audio_key_estimation_torch.utils.key_signatures import KEY_SIGNATURE_MAP

JOIN_LIMIT_S = 120.0


def _entry(rank: int, world: int, store: str, out_dir: str):
    torch.set_num_threads(1)
    path = os.path.join(out_dir, f"rank{rank}")
    try:
        fn, args = torch.load(os.path.join(out_dir, "job.pt"),
                              weights_only=False)
        init_data_parallel("cpu", init_method=f"file://{store}", rank=rank,
                           world_size=world, timeout_s=JOIN_LIMIT_S)
        result = fn(*args)
        torch.save(result, path + ".pt")
    except BaseException:
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


class Ranks:
    """`world` processes running fn(*args) on gloo ranks, started at once;
    results() joins them (within the join limit) and returns their
    results in rank order."""

    def __init__(self, fn, world: int, tmp_path, *args,
                 timeout: float = JOIN_LIMIT_S):
        self.out_dir = str(tmp_path / f"ranks_{fn.__name__}_{world}_"
                                      f"{time.time_ns()}")
        os.makedirs(self.out_dir)
        store = os.path.join(self.out_dir, "store")
        # the job goes through a file: a large argument written down the
        # start pipe would hold each start until that child has imported
        # torch, so the ranks would boot one after another
        torch.save((fn, args), os.path.join(self.out_dir, "job.pt"))
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_entry, args=(
            r, world, store, self.out_dir)) for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout

    def results(self) -> list:
        for p in self.procs:
            p.join(max(self.deadline - time.monotonic(), 0.0))
        hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join()
        errors = []
        for r, p in enumerate(self.procs):
            err = os.path.join(self.out_dir, f"rank{r}.err")
            if os.path.exists(err):
                errors.append(f"rank {r}:\n" + open(err).read())
            elif p.exitcode != 0 and r not in hung:
                errors.append(f"rank {r}: exit code {p.exitcode}")
        if hung or errors:
            raise AssertionError(
                "\n".join(errors) or f"ranks {hung} still running after "
                                     f"{self.timeout} s")
        return [torch.load(os.path.join(self.out_dir, f"rank{r}.pt"),
                           weights_only=False)
                for r in range(len(self.procs))]


def spawn_ranks(fn, world: int, tmp_path, *args,
                timeout: float = JOIN_LIMIT_S) -> list:
    """fn(*args) on each of `world` gloo ranks; their results in rank
    order."""
    return Ranks(fn, world, tmp_path, *args, timeout=timeout).results()


# ---------------------------------------------------------------------------
# helpers shared by the ranks and the tests' single-process side
# ---------------------------------------------------------------------------

def numpy_state(module: torch.nn.Module) -> dict:
    return {k: v.detach().cpu().numpy().copy()
            for k, v in module.state_dict().items()}


def port_state(cfg: Config, weights: dict,
               dtype: torch.dtype = torch.float32) -> trainer.TrainState:
    """create_train_state on the CPU with `weights` (a numpy state_dict),
    the model's parameters and buffers in `dtype`."""
    state = trainer.create_train_state(cfg, 0, "cpu")
    state.model.to(dtype)
    state.model.load_state_dict({k: torch.from_numpy(np.array(v))
                                 for k, v in weights.items()})
    return state


def batch_tensors(batch: dict, dtype: torch.dtype = torch.float32) -> dict:
    """A numpy batch as CPU tensors, its floating arrays in `dtype`."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dtype)
            if np.issubdtype(v.dtype, np.floating)
            else torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def step_result(state: trainer.TrainState, loss: float) -> dict:
    return {"loss": loss,
            "params": {k: p.detach().numpy().copy()
                       for k, p in state.model.named_parameters()},
            "grads": {k: p.grad.detach().numpy().copy()
                      for k, p in state.model.named_parameters()
                      if p.grad is not None},
            "buffers": {k: b.detach().numpy().copy()
                        for k, b in state.model.named_buffers()}}


def single_step(cfg: Config, weights: dict, batch: dict, seed: int = 0,
                dtype: torch.dtype = torch.float32) -> dict:
    """One train_step of one process on the whole (acc, micro, ...)
    batch, computing in `dtype`."""
    state = port_state(cfg, weights, dtype)
    step = trainer.make_train_step(cfg, 1, seed=seed)
    m = step(state, batch_tensors(batch, dtype))
    return step_result(state, float(m["loss"]))


def synthetic_dataset(cfg: Config, n: int, seed: int, t_max: int = 32,
                      genre_every: int = 0) -> KeyDataset:
    """A KeyDataset of n random songs (mel, labels) on the CPU; with
    genre_every k, every k-th song carries a genre label."""
    rng = np.random.default_rng(seed)
    ds = KeyDataset(cfg.genre, cfg, blacklist_path="", device="cpu")
    for i in range(n):
        t = int(rng.integers(t_max // 2, t_max + 1))
        row = int(rng.integers(0, 21))
        sig = np.zeros(24, np.float32)
        sig[int(rng.integers(0, 24))] = 1
        genre = np.zeros(11, np.float32)
        if genre_every and i % genre_every == 0:
            genre[int(rng.integers(0, 11))] = 1
        ds.items.append({
            "file": f"s{i}", "dataset": "synthetic",
            "mel": rng.normal(size=(cfg.pitches, t)).astype(np.float32),
            "key_labels": KEY_SIGNATURE_MAP[row].astype(np.float32),
            "key_signature_id": sig,
            "tonic_labels": np.eye(12, dtype=np.float32)[
                int(rng.integers(0, 12))],
            "genre": genre, "seq_length": np.int32(t)})
    return ds


# ---------------------------------------------------------------------------
# worker functions (run on every rank)
# ---------------------------------------------------------------------------

def dp_train_steps(cases: list) -> list:
    """For each case (cfg, numpy weights, global (acc, micro, ...) batch,
    dropout seed, dtype): one data-parallel train_step on this rank's
    rows of every micro-batch, computing in dtype. Returns per case the
    global loss (the ranks' shares summed), parameters, gradients and
    buffers after the step."""
    rank, world = data_world()
    out = []
    for cfg, weights, batch, seed, dtype in cases:
        state = port_state(cfg, weights, dtype)
        trainer.data_parallel(state)
        rows = rank_rows(batch["mel"].shape[1], rank, world)
        local = batch_tensors({k: v[:, rows] for k, v in batch.items()},
                              dtype)
        m = trainer.make_train_step(cfg, 1, seed=seed)(state, local)
        out.append(step_result(state, trainer.global_losses([m["loss"]])[0]))
    return out


def dp_evaluate(cfg: Config, weights: dict, n: int, seed: int,
                genre_every: int = 0) -> dict:
    """evaluate(..., sharded=True) over synthetic_dataset(cfg, n, seed)."""
    state = port_state(cfg, weights)
    ds = synthetic_dataset(cfg, n, seed, genre_every=genre_every)
    return trainer.evaluate(trainer.make_eval_step(cfg), state, ds,
                            cfg.batch_size, sharded=True)


def dp_fit(cfg: Config, log_dir: str, n_train: int, n_val: int,
           resume: bool = False, eval_at_start: bool = False) -> dict:
    """Trainer.fit on synthetic training and validation sets (seeds 1
    and 2). Returns the history, the rows given to the metrics writer,
    the checkpoint writes this rank made, the files in log_dir after the
    fit, the final weights and the step."""
    from audio_key_estimation_torch.train import checkpoints as ckpt_lib
    train = synthetic_dataset(cfg, n_train, 1)
    val = synthetic_dataset(cfg, n_val, 2)
    rows, saves = [], []

    def recording(fn):
        def call(run_dir, *args, **kw):
            saves.append(fn.__name__)
            return fn(run_dir, *args, **kw)
        return call
    save, save_train_state = ckpt_lib.save, ckpt_lib.save_train_state
    ckpt_lib.save = recording(save)
    ckpt_lib.save_train_state = recording(save_train_state)
    try:
        tr = trainer.Trainer(cfg, train, val, log_dir=log_dir, device="cpu")
        state, hist = tr.fit(seed=0, metrics_writer=rows.append,
                             resume=resume, eval_at_start=eval_at_start)
    finally:
        ckpt_lib.save, ckpt_lib.save_train_state = save, save_train_state
    return {"history": hist, "written_rows": rows, "saves": saves,
            "step": state.step,
            "files": sorted(os.listdir(log_dir))
            if os.path.isdir(log_dir) else [],
            "weights": numpy_state(state.model)}


def dp_fit_without_mesh(cfg: Config) -> str:
    """Trainer(use_mesh=False).fit under the group: the ValueError's
    message, or "" where it did not raise."""
    tr = trainer.Trainer(cfg, synthetic_dataset(cfg, 8, 1),
                         synthetic_dataset(cfg, 4, 2), device="cpu",
                         use_mesh=False)
    try:
        tr.fit(seed=0)
    except ValueError as e:
        return str(e)
    return ""


def dp_cli(workdir: str, train_args: list, eval_args: list) -> dict:
    """cli/train.py, then cli/eval.py, with workdir as the working
    directory. Returns both results."""
    from audio_key_estimation_torch.cli import eval as eval_cli
    from audio_key_estimation_torch.cli import train as train_cli
    os.chdir(workdir)
    val = train_cli.main(train_args)
    results = eval_cli.main(eval_args)
    return {"val": val, "eval": results}


def run_jobs(jobs: list) -> list:
    """Each (worker function, args) of `jobs` in turn, on this rank: one
    spawn serves several checks."""
    return [fn(*args) for fn, args in jobs]
