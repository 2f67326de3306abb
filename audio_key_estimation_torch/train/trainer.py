"""Training/eval harness: gradient accumulation, data parallelism, early
stopping and best-on-val-MIREX checkpointing.

The port of the JAX package's train/trainer.py (itself the reference's
PyTorch-Lightning wiring, models.py:819-1027, train_model.py:110-124):

 * `train_step` — `acc_grad` micro-batches through autograd (the
   reference's Trainer(accumulate_grad_batches=8)), BatchNorm running
   statistics carried from one micro-batch to the next, the gradients
   averaged, one Adam update; dropout masks drawn from the model's
   generator, seeded per micro-batch from (fit seed, step, micro index)
   as the JAX step folds them into its PRNG key.
 * `eval_step` — eval-mode forward (kernel C takes every ConvStack its
   gate admits, as serving does) + loss + per-sample MIREX categories.
 * `Trainer.fit` — epoch loop, per-epoch validation, EarlyStopping
   (val_loss, patience, min mode — train_model.py:110), best-model save on
   improved val MIREX (models.py:991-993), a resume snapshot each epoch.

Runs on the CUDA card by default; without CUDA it raises unless the CPU
is asked for (device="cpu").

Data parallelism (`Trainer(use_mesh=True)`, the default, as in the JAX
package): under a process group of world > 1 (torchrun, one process per
card: parallel/mesh.init_data_parallel) the model trains in
DistributedDataParallel and each rank takes its rows (rank_rows) of
every micro-batch of the same shuffled global batch. BatchNorm
statistics and dropout masks are the global micro-batch's
(models/blocks.set_data_shard) and each rank backpropagates its share of
the global loss (train/loss.loss_share) times the world size, which
DDP's gradient average turns into the global loss's gradient: the step
is the JAX sharded step. `evaluate` runs each rank's rows and
all-reduces its sums once; every rank then takes the same early-stop and
best-model decisions, and rank 0 alone writes the run directory. With
no group, or a world of 1, the step is the single-process one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import time
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
from torch.nn.parallel import DistributedDataParallel

from ..config import Config
from ..data.pipeline import prefetch
from ..models.blocks import set_data_shard
from ..models.multi_scale import build_model
from ..parallel.mesh import (all_reduce_, barrier, check_mesh_shape,
                             data_world, rank_rows)
from ..utils.precision import ieee_float32
from ..utils.profiling import span
from . import checkpoints as ckpt_lib
from .loss import compute_loss, loss_from_sums, loss_share, loss_sums, \
    loss_totals
from .metrics import mirex_categories
from .optim import learning_rate, make_optimizer, set_learning_rate

# evaluate(): batches whose results may be in flight before the host waits
MAX_INFLIGHT = 4


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module      # PitchClassNet or PitchClassNetMulti
    optimizer: torch.optim.Adam
    step: int = 0
    # the model in DistributedDataParallel under a group of world > 1
    ddp: Optional[DistributedDataParallel] = None


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r}: CUDA is not available "
                           "(pass device='cpu' to train on the CPU)")
    return device


def create_train_state(cfg: Config, seed: int = 0,
                       device: Union[str, torch.device] = "cuda"
                       ) -> TrainState:
    """The model `cfg` describes (build_model: PitchClassNet or the
    multi-scale ensemble) initialized from torch.Generator seed `seed` on
    `device`, its dropout generator there, and Adam over its
    parameters."""
    device = resolve_device(device)
    model = build_model(cfg, generator=torch.Generator().manual_seed(seed))
    model.to(device)
    model.set_dropout_generator(torch.Generator(device=device))
    return TrainState(model, make_optimizer(cfg, model.parameters()))


def data_parallel(state: TrainState) -> None:
    """Train `state` as this rank of the process group: BatchNorm and
    dropout over the global micro-batch, the model wrapped in DDP
    (buffers not broadcast: every rank computes the same running
    statistics). find_unused_parameters stays off: every head the Config
    builds (key and tonic, genre only with cfg.genre, the ensemble's
    merge weights only with linear_reg_multi) feeds compute_loss, so
    each step reaches every parameter."""
    rank, world = data_world()
    set_data_shard(state.model, (rank, world))
    dev = next(state.model.parameters()).device
    # newer torch names the switch forward_sync_buffers
    buffers_kw = ("forward_sync_buffers" if "forward_sync_buffers" in
                  inspect.signature(DistributedDataParallel).parameters
                  else "broadcast_buffers")
    state.ddp = DistributedDataParallel(
        state.model, device_ids=[dev] if dev.type == "cuda" else None,
        find_unused_parameters=False, **{buffers_kw: False})


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batches() dict of numpy arrays as tensors on `device`."""
    with span("akx.to_device"):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in batch.items()}


def forward(model: torch.nn.Module, cfg: Config, batch):
    # seq_length masks the temporal pooling in every mode (the JAX
    # trainer's _forward): bucketed batches pad, and an unmasked mean would
    # make a song's score depend on its batch's bucket; the multi-scale
    # ensemble takes the 12-bin CQT (mel2) beside mel
    mels = ((batch["mel"], batch["mel2"]) if cfg.multi_scale
            else (batch["mel"],))
    return model(*mels, batch.get("seq_length"))


def dropout_seed(seed: int, step: int, idx: int) -> int:
    """The dropout generator's seed for micro-batch `idx` of update
    `step`: the counterpart of fold_in(fold_in(PRNGKey(seed), step), idx)
    (the bits differ from JAX's; the masks are independent per seed, step
    and micro-batch)."""
    return int(np.random.SeedSequence([seed, step, idx])
               .generate_state(1, np.uint64)[0])


def make_train_step(cfg: Config, steps_per_epoch: int,
                    seed: Optional[int] = None):
    """Returns train_step(state, batch) -> {"loss": mean micro loss}.

    batch tensors are stacked (acc_grad, micro_bs, ...). `seed` feeds the
    per-micro-batch dropout seeds (defaults to cfg.seed). The step leaves
    the averaged gradients in each parameter's .grad. Under data
    parallelism (state.ddp) batch holds this rank's rows, the gradients
    are the global batch's and "loss" is this rank's share of the mean
    micro loss: the shares add up to it over the ranks (global_losses).
    float32 work runs in IEEE float32 (utils/precision.ieee_float32), as
    in eval_step."""
    rng_seed = cfg.seed if seed is None else seed

    @ieee_float32("train_step")
    def train_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        with span("akx.train_step", request=state.step):
            return update(state, batch)

    def update(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        model, opt, ddp = state.model, state.optimizer, state.ddp
        net = model if ddp is None else ddp
        net.train()
        opt.zero_grad(set_to_none=True)
        acc = batch["mel"].shape[0]
        micros = [{k: v[idx] for k, v in batch.items()}
                  for idx in range(acc)]
        if ddp is not None:
            # the global counts each micro-batch's loss divides by, for
            # every micro-batch in one all-reduce
            totals = all_reduce_(torch.stack([loss_totals(cfg, m)
                                              for m in micros]))
            world = data_world()[1]
        losses = []
        for idx, micro in enumerate(micros):
            if cfg.drop > 0:
                model.dropout_generator.manual_seed(
                    dropout_seed(rng_seed, state.step, idx))
            if ddp is None:
                with span("akx.forward"):
                    loss, _ = compute_loss(cfg, forward(model, cfg, micro),
                                           micro)
                with span("akx.backward"):
                    loss.backward()
            else:
                # gradients are all-reduced once, after the last
                # micro-batch; DDP averages them over the ranks, so each
                # rank backpropagates world x its share
                sync = idx == acc - 1
                with contextlib.nullcontext() if sync else ddp.no_sync():
                    with span("akx.forward"):
                        loss = loss_share(cfg, forward(ddp, cfg, micro),
                                          micro, totals[idx])
                    with span("akx.backward"):
                        (loss * world).backward()
            losses.append(loss.detach())
        with span("akx.optimizer"):
            grads = [p.grad for p in model.parameters()
                     if p.grad is not None]
            torch._foreach_div_(grads, acc)
            set_learning_rate(opt, learning_rate(cfg, state.step,
                                                 steps_per_epoch))
            opt.step()
        state.step += 1
        return {"loss": torch.stack(losses).mean()}

    return train_step


def global_losses(losses: list) -> list:
    """Per-step losses as floats: under a group of world > 1 each rank's
    shares summed over the ranks in one all-reduce (the host waits once),
    else read as they are."""
    if not losses:
        return []
    t = torch.stack(losses)
    if data_world()[1] > 1:
        all_reduce_(t)
    return [float(x) for x in t.cpu()]


def make_eval_step(cfg: Config):
    """Returns eval_step(state, batch, sharded=False) -> (loss, per-sample
    metric tensors); with sharded=True the loss's place holds this
    rank's loss_sums and loss_totals, (4,), for evaluate to all-reduce."""

    @torch.inference_mode()
    @ieee_float32("eval_step")
    def eval_step(state: TrainState, batch, sharded: bool = False):
        model = state.model
        model.eval()
        outputs = forward(model, cfg, batch)
        # `valid` masks repeat-padded duplicate rows out of the loss;
        # train=False keeps straddle down-weighting out of val_loss
        if sharded:
            loss = torch.cat([
                loss_sums(cfg, outputs, batch, batch["valid"], train=False),
                loss_totals(cfg, batch, batch["valid"])])
        else:
            loss, _ = compute_loss(cfg, outputs, batch,
                                   sample_weights=batch.get("valid"),
                                   train=False)
        if cfg.genre:
            key_out, tonic_out, genre_out = outputs
        else:
            key_out, tonic_out = outputs
            genre_out = None
        cats = mirex_categories(batch["key_labels"], key_out,
                                batch["tonic_labels"], tonic_out,
                                batch["key_signature_id"])
        tonic_ok = (torch.argmax(tonic_out, -1)
                    == torch.argmax(batch["tonic_labels"], -1))
        if cfg.local:
            # per-window categories averaged over each sample's valid
            # windows
            valid = torch.clamp(batch["seq_length"]
                                - cfg.loc_window_size * cfg.frames + 1,
                                min=0)
            t = key_out.shape[1]
            mask = (torch.arange(t, device=key_out.device)[None, :]
                    < valid[:, None])
            denom = torch.clamp(valid, min=1)

            def per_sample_mean(v):
                return torch.sum(torch.where(mask, v, 0), dim=1) / denom
            cats = {k: per_sample_mean(v) for k, v in cats.items()}
            acc_tonic = per_sample_mean(tonic_ok)
        else:
            acc_tonic = tonic_ok.float()
        per_sample = dict(cats)
        per_sample["accuracy_tonic"] = acc_tonic
        if genre_out is not None:
            gmask = torch.sum(batch["genre"], dim=1) == 1
            if cfg.local:
                # per-window genre accuracy over valid windows, the genre
                # head's longer time axis cut to the key head's T windows
                ok = (torch.argmax(genre_out[:, :t], -1)
                      == torch.argmax(batch["genre"], -1)[:, None])
                acc_genre = per_sample_mean(ok)
            else:
                acc_genre = (torch.argmax(genre_out, -1)
                             == torch.argmax(batch["genre"], -1))
            per_sample["accuracy_genre"] = acc_genre.float()
            per_sample["genre_labeled"] = gmask.float()
        return loss, per_sample

    eval_step.cfg = cfg
    return eval_step


CATEGORIES = ("mirex", "correct", "fifths", "relative", "parallel", "other",
              "accuracy", "accuracy_tonic")


def evaluate(eval_step, state: TrainState, dataset, batch_size: int,
             sharded: bool = False) -> Dict[str, float]:
    """Masked aggregation over a dataset (repeat-padded rows excluded).

    Results stay on the device while batches are dispatched; the masked
    reduction happens once at the end. The host waits on the oldest
    result whenever MAX_INFLIGHT batches are in flight, so a large
    validation set cannot queue its whole input stream in device memory.

    sharded: each rank of the process group evaluates its rows
    (rank_rows) of every batch; its sums (each batch's loss numerators
    and counts, the MIREX categories, genre hits and counts) are
    all-reduced once at the end, and every rank returns the same
    aggregates: those of the whole dataset, as the JAX package's evaluate
    over a mesh gives them.
    """
    if sharded:
        return _evaluate_sharded(eval_step, state, dataset, batch_size)
    device = next(state.model.parameters()).device
    pending = []  # (valid_mask, loss, per_sample) on the device
    for batch in dataset.batches(batch_size):
        valid = np.asarray(batch["valid"])
        batch["valid"] = valid.astype(np.float32)  # device-side loss mask
        loss, per_sample = eval_step(state, to_device(batch, device))
        pending.append((valid, loss, per_sample))
        if len(pending) >= MAX_INFLIGHT:
            float(pending[-MAX_INFLIGHT][1])
    sums: Dict[str, float] = {}
    loss_sum = loss_weight = 0.0
    n_samples = 0
    genre_hits = genre_cnt = 0.0
    for v, loss, per_sample in pending:
        # batch losses are means over that batch's VALID rows; weight by
        # the valid count so every real sample counts once
        loss_sum += float(loss) * v.sum()
        loss_weight += v.sum()
        n_samples += v.sum()
        ps = {k: x.cpu().numpy() for k, x in per_sample.items()}
        for k in CATEGORIES:
            if k in ps:
                sums[k] = sums.get(k, 0.0) + float(ps[k][v].sum())
        if "genre_labeled" in ps:
            genre_hits += float((ps["accuracy_genre"]
                                 * ps["genre_labeled"])[v].sum())
            genre_cnt += float(ps["genre_labeled"][v].sum())
    out = {k: s / max(n_samples, 1) for k, s in sums.items()}
    out["loss"] = (loss_sum / loss_weight) if loss_weight else float("nan")
    out["accuracy_genre"] = genre_hits / genre_cnt if genre_cnt else 0.0
    out["num_samples"] = int(n_samples)
    return out


def _evaluate_sharded(eval_step, state: TrainState, dataset,
                      batch_size: int) -> Dict[str, float]:
    rank, world = data_world()
    rows = rank_rows(batch_size, rank, world)
    device = next(state.model.parameters()).device
    pending = []  # per batch: (4,) loss sums and totals, (K,) metric sums
    keys = None
    for batch in dataset.batches(batch_size):
        batch["valid"] = np.asarray(batch["valid"]).astype(np.float32)
        local = to_device({k: v[rows] for k, v in batch.items()}, device)
        loss, per_sample = eval_step(state, local, sharded=True)
        v = local["valid"]
        keys = [k for k in CATEGORIES if k in per_sample]
        metric = [torch.sum(per_sample[k] * v) for k in keys]
        if "genre_labeled" in per_sample:
            g = per_sample["genre_labeled"] * v
            metric += [torch.sum(per_sample["accuracy_genre"] * g),
                       torch.sum(g)]
        pending.append(torch.cat([loss, torch.stack(metric)]))
        if len(pending) >= MAX_INFLIGHT:
            float(pending[-MAX_INFLIGHT][0])
    if not pending:
        return {"loss": float("nan"), "accuracy_genre": 0.0,
                "num_samples": 0}
    sums = all_reduce_(torch.stack(pending)).double().cpu()
    loss_sum = n_samples = 0.0
    for b in sums:
        # each batch's loss over its valid rows, weighted by their count
        loss_sum += float(loss_from_sums(eval_step.cfg, b[:2],
                                         b[2:4])) * float(b[2])
        n_samples += float(b[2])
    total = sums[:, 4:].sum(0)
    out = {k: float(total[i]) / max(n_samples, 1)
           for i, k in enumerate(keys)}
    out["loss"] = loss_sum / n_samples if n_samples else float("nan")
    genre_cnt = float(total[-1]) if total.numel() > len(keys) else 0.0
    out["accuracy_genre"] = (float(total[-2]) / genre_cnt if genre_cnt
                             else 0.0)
    out["num_samples"] = int(round(n_samples))
    return out


# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Trainer:
    """Epoch loop with early stopping + checkpointing
    (train_model.py:110-124); data-parallel over the process group when
    its world is > 1. use_mesh=False (the JAX package's single-device
    fit) is refused there: ranks training alone would each write the one
    run directory."""
    cfg: Config
    train_data: Any
    val_data: Any
    log_dir: Optional[str] = None
    device: Union[str, torch.device] = "cuda"
    use_mesh: bool = True

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def fit(self, seed: int = 0, metrics_writer=None, resume: bool = False,
            eval_at_start: bool = False):
        cfg = self.cfg
        micro_bs = cfg.batch_size
        step_items = micro_bs * cfg.acc_grad
        steps_per_epoch = max(len(self.train_data) // step_items, 1)
        rank, world = data_world()
        if not self.use_mesh and world > 1:
            raise ValueError(f"Trainer(use_mesh=False) under a process "
                             f"group of {world} ranks")
        check_mesh_shape(cfg.mesh_shape, world)
        sharded = world > 1
        rows = rank_rows(micro_bs, rank, world)
        # rank 0 alone writes the run directory and the metrics
        writes = rank == 0
        log_dir = self.log_dir if writes else None
        state = create_train_state(cfg, seed, self.device)
        train_step = make_train_step(cfg, steps_per_epoch, seed=seed)
        eval_step = make_eval_step(cfg)
        self.state, self.eval_step = state, eval_step

        best_mirex = -1.0
        best_val_loss = float("inf")
        patience_left = cfg.early_stop_patience
        history = []
        start_epoch = 0
        if resume and self.log_dir and ckpt_lib.has_train_state(
                self.log_dir):
            state.step, last_epoch, extra = ckpt_lib.load_train_state(
                self.log_dir, state.model, state.optimizer)
            start_epoch = last_epoch + 1
            best_mirex = extra.get("best_mirex", -1.0)
            best_val_loss = extra.get("best_val_loss", float("inf"))
            if writes:
                print(f"resumed from epoch {last_epoch}", flush=True)
        if sharded:
            data_parallel(state)

        def report(row, text):
            history.append(row)
            if writes:
                if metrics_writer is not None:
                    metrics_writer(row)
                print(text, flush=True)

        if eval_at_start and start_epoch == 0:
            # untrained-model validation (epoch -1): the chance floor the
            # learning curves are judged against
            val = evaluate(eval_step, state, self.val_data, micro_bs,
                           sharded)
            report({"epoch": -1, "train_loss": float("nan"),
                    "epoch_seconds": 0.0,
                    **{f"val_{k}": v for k, v in val.items()}},
                   f"epoch -1 (untrained): val_loss={val['loss']:.4f} "
                   f"val_mirex={val.get('mirex', 0):.4f}")

        def device_batches(epoch):
            """Reshape, this rank's rows, H2D on the producer thread so
            host-side batch prep overlaps device compute."""
            for batch in self.train_data.batches(step_items, shuffle=True,
                                                 seed=seed + epoch,
                                                 drop_last=True):
                batch.pop("valid", None)
                batch = {k: np.reshape(v, (cfg.acc_grad, micro_bs)
                                       + v.shape[1:])[:, rows]
                         for k, v in batch.items()}
                yield to_device(batch, self.device)

        for epoch in range(start_epoch, cfg.epochs):
            t0 = time.time()
            train_losses = []
            for batch in prefetch(device_batches(epoch)):
                # the loss stays on the device: read once per epoch
                train_losses.append(train_step(state, batch)["loss"])
            train_losses = global_losses(train_losses)
            val = evaluate(eval_step, state, self.val_data, micro_bs,
                           sharded)
            row = {"epoch": epoch,
                   "train_loss": float(np.mean(train_losses))
                   if train_losses else float("nan"),
                   "epoch_seconds": time.time() - t0,
                   **{f"val_{k}": v for k, v in val.items()}}
            report(row, f"epoch {epoch}: train_loss={row['train_loss']:.4f} "
                        f"val_loss={val['loss']:.4f} "
                        f"val_mirex={val.get('mirex', 0):.4f}")

            # every rank decides from the same all-reduced aggregates
            if val.get("mirex", 0) > best_mirex and not cfg.no_ckpt:
                best_mirex = val["mirex"]
                if log_dir:
                    ckpt_lib.save(log_dir, state.model, cfg,
                                  name="best_model")
            if log_dir and not cfg.no_ckpt:
                ckpt_lib.save_train_state(
                    log_dir, state.model, state.optimizer, state.step,
                    cfg, epoch,
                    extra={"best_mirex": float(best_mirex),
                           "best_val_loss": float(min(best_val_loss,
                                                      val["loss"]))})
            if val["loss"] < best_val_loss:
                best_val_loss = val["loss"]
                patience_left = cfg.early_stop_patience
            else:
                patience_left -= 1
                if patience_left <= 0:
                    if writes:
                        print(f"early stop at epoch {epoch}", flush=True)
                    break
        # the other ranks read what rank 0 wrote only after it wrote it
        if sharded:
            barrier()
        return state, history
