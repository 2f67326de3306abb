"""Training steps: the researchers' path.

Mix parameters: a corpus of `songs` precomputed features, half of them
`seconds[0]` and half `seconds[1]` long (dealt in a seeded order), at
`sr` and the configuration's frame rate: seeded log1p-CQT-like values
(log1p of |N(0, 1)| / 2) and a random key (tonic and mode) a song. A
step is `batch_size` x `acc_grad` songs, as the reference trains. The
system's own `KeyDataset.batches` draws and pads each step (buckets
512 / 1024 / ... frames), `Trainer.fit`'s reshape and `to_device` move
it, on `prefetch`'s producer thread as `fit` does, and `make_train_step`'s
`train_step` runs it; the window reads each step's loss.

Set-up builds one training state from the benchmark's weights and runs
its first `check_steps` steps through the window's own feed and call;
they are the warm-up, and what the check follows: the reference runs the
same steps from the same weights on the same batches, and the check
compares each step's loss, the first gradient as Adam holds it after one
step, and the parameters' change after the last of them. Leaves whose
gradient is nought in the reference are not held: the rule reads the
reference's first gradient computed in float64, where a conv's bias
ahead of a training-mode BatchNorm reads nought and not its round-off.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from .. import stand_in
from ..readings import Readings
from ..reference import serve as ref_serve
from ..reference import train as ref_train
from ..yardstick import profile as prof

_SCALE = (0, 2, 4, 5, 7, 9, 11)
# leaves whose float64 reference gradient is under this share of the
# median leaf's have none (a conv's bias ahead of a training-mode
# BatchNorm): Adam moves them by round-off alone, so they are not held
NOUGHT = 1e-3


class Program:
    """The system under test: the port's training state, loaded with the
    benchmark's weights, and make_train_step's train_step."""

    def __init__(self, cfg, sd: dict, device, steps_per_epoch: int):
        from audio_key_estimation_torch.models.convert import load_state_dict
        from audio_key_estimation_torch.train import trainer
        self.state = trainer.create_train_state(cfg, 0, device)
        load_state_dict(self.state.model, {k: v.cpu() for k, v in sd.items()})
        self.train_step = trainer.make_train_step(cfg, steps_per_epoch,
                                                  seed=0)

    def __call__(self, batch: dict) -> float:
        return float(self.train_step(self.state, batch)["loss"])

    def first_moment(self) -> dict:
        """Adam's first moment, by the parameters' names."""
        st = self.state.optimizer.state
        return {k: (st[p]["exp_avg"] if "exp_avg" in st.get(p, {})
                    else torch.zeros_like(p))
                for k, p in self.state.model.named_parameters()}

    def params(self) -> dict:
        return {k: p.detach().clone()
                for k, p in self.state.model.named_parameters()}


class Traffic:
    def __init__(self, ctx):
        self.ctx = ctx
        mix, model = ctx.mix, ctx.model
        self.sr = mix["sr"]
        self.hop = int(round(self.sr / model["frames"]))
        n = mix["songs"]
        secs = [mix["seconds"][i % 2] for i in range(n)]
        order = np.random.default_rng(ctx.sub_seed(3)).permutation(n)
        self.frames = [1 + int(secs[j] * self.sr) // self.hop for j in order]
        self.step_songs = mix["batch_size"] * mix["acc_grad"]
        self.attempted = self.failed = 0

    def corpus(self):
        """KeyDataset items, made on the device in one call a length."""
        ctx, model = self.ctx, self.ctx.model
        rows = model["octaves"] * model["bins_per_octave"]
        g = torch.Generator(device=ctx.device).manual_seed(ctx.sub_seed(6))
        rng = np.random.default_rng(ctx.sub_seed(7))
        mels = {}
        for t in sorted(set(self.frames)):
            k = self.frames.count(t)
            x = torch.randn((k, rows, t), generator=g, device=ctx.device)
            mels[t] = list(torch.log1p(x.abs() * 0.5).cpu().numpy())
        signatures = ref_serve.signature_map()
        items = []
        for t in self.frames:
            tonic, minor = int(rng.integers(12)), bool(rng.integers(2))
            major = (tonic + 3) % 12 if minor else tonic
            key = np.zeros(12, np.float32)
            key[[(major + s) % 12 for s in _SCALE]] = 1.0
            sig = np.zeros(len(signatures), np.float32)
            sig[int(np.argmax(signatures @ key))] = 1.0
            onehot = np.zeros(12, np.float32)
            onehot[tonic] = 1.0
            items.append({"mel": mels[t].pop(), "key_labels": key,
                          "key_signature_id": sig, "tonic_labels": onehot,
                          "genre": np.zeros(11, np.float32),
                          "seq_length": np.int32(t)})
        return items

    def setup(self, sd: dict) -> None:
        from audio_key_estimation_torch.data.dataset import KeyDataset
        from audio_key_estimation_torch.data.pipeline import prefetch
        from audio_key_estimation_torch.train import trainer
        ctx, mix = self.ctx, self.ctx.mix
        cfg = ctx.program_config().replace(batch_size=mix["batch_size"],
                                           acc_grad=mix["acc_grad"])
        self.sd0 = {k: v.detach().clone() for k, v in sd.items()}
        ds = KeyDataset(False, cfg, device=ctx.device, blacklist_path=None)
        ds.items = self.corpus()
        steps_per_epoch = max(len(ds) // self.step_songs, 1)
        self.system = (stand_in.Trainer(ctx, sd, ctx.stand_in)
                       if ctx.stand_in
                       else Program(cfg, sd, ctx.device, steps_per_epoch))
        self.kept = []            # the host batches of the checked steps
        micro = mix["batch_size"]

        def batches():
            epoch = 0
            while True:
                for batch in ds.batches(self.step_songs, shuffle=True,
                                        seed=ctx.sub_seed(8, epoch),
                                        drop_last=True):
                    batch.pop("valid", None)
                    batch = {k: np.reshape(v, (cfg.acc_grad, micro)
                                           + v.shape[1:])
                             for k, v in batch.items()}
                    if len(self.kept) < mix["check_steps"]:
                        self.kept.append(batch)
                    yield (trainer.to_device(batch, ctx.device),
                           batch["seq_length"].ravel())
                epoch += 1

        self.feed = prefetch(batches())
        self.clips = {}
        self.losses = []
        for i in range(mix["check_steps"]):
            self.losses.append(self.step())
            if i == 0:    # Adam's first moment after one step: (1 - b1) g
                self.grad1 = {k: v / (1 - ref_train.BETAS[0]) for k, v
                              in self.system.first_moment().items()}
        self.after = self.system.params()

    def step(self) -> float:
        """One step through the window's feed and call; its loss read."""
        batch, seq = next(self.feed)
        loss = self.system(batch)
        for t in seq.tolist():
            self.clips[t] = self.clips.get(t, 0) + 1
        return loss

    def window(self, seconds: float, traced: bool = False) -> None:
        self.clips = {}
        steps = 0
        t0 = time.perf_counter()
        while True:
            self.step()
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self.window_s = time.perf_counter() - t0
        self.steps = steps
        self.attempted = steps * self.step_songs

    def end_to_end(self) -> dict:
        return {"train_songs_per_s":
                self.steps * self.step_songs / self.window_s}

    def trace(self) -> Readings:
        n = 2

        def steps():
            for _ in range(n):
                with record_function("bench.step"):
                    self.step()

        clips = dict(self.clips)
        p = prof.profiled(steps, self.ctx.device)
        return Readings(
            profile=p, calls=n, call_minutes=0.0,
            geometry={"cqts": [], "stacks": []}, model=self.ctx.model,
            sr=self.sr, hop=self.hop, window_s=self.window_s,
            window_minutes=sum(t * k for t, k in clips.items()) * self.hop
            / self.sr / 60.0,
            window_clips=clips, spans={}, training=True)

    def release(self) -> None:
        del self.system, self.feed
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def close(self) -> None:
        self.kept = None

    # ------------------------------------------------------------------
    def batch(self, i: int, dtype=torch.float32) -> dict:
        """Checked step `i`'s host batch as the reference reads it."""
        out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            self.ctx.device)
            for k, v in self.kept[i].items() if k in stand_in.BATCH_KEYS}
        out["mel"] = out["mel"].to(dtype)
        return out

    def reference(self) -> tuple:
        """The reference's losses, first gradients and change of the
        parameters over the checked steps, from the same weights on the
        same batches, and its first gradient in float64."""
        ctx = self.ctx
        sd = {k: v.clone() for k, v in self.sd0.items()}
        adam = ref_train.Adam({k: v for k, v in sd.items()
                               if ref_train.is_parameter(k)},
                              ctx.program_config().lr)
        losses, grad1 = [], None
        with torch.enable_grad():
            for i in range(len(self.kept)):
                loss, grads = ref_train.step(sd, ctx.model, self.batch(i),
                                             adam)
                losses.append(float(loss))
                grad1 = grads if grad1 is None else grad1
            sd64 = {k: v.double() for k, v in self.sd0.items()}
            _, exact = ref_train.step(sd64, ctx.model,
                                      self.batch(0, torch.float64), None,
                                      frozen=True)
        delta = {k: sd[k] - self.sd0[k] for k in grad1}
        return losses, grad1, delta, exact

    @staticmethod
    def compare(got: tuple, want: tuple) -> dict:
        """Each leaf's gap is the gap between the two norms over the
        larger of the reference leaf's norm and the median leaf's; leaves
        whose float64 reference gradient is nought are left out.
          loss1_rel  the first step's loss gap over the reference's loss;
          loss_rel   the worst step's;
          grad_rel   the worst leaf's gap of the first gradient;
          delta_rel  the worst leaf's gap of the parameters' change."""
        (gl, gg, gd), (wl, wg, wd, exact) = got, want
        loss = [abs(a - b) / abs(b) for a, b in zip(gl, wl)]
        gn = {k: float(v.norm()) for k, v in exact.items()}
        med = float(np.median(list(gn.values())))
        held = [k for k, v in gn.items() if v >= NOUGHT * med]

        def gaps(a, b):
            na = {k: float(a[k].norm()) for k in held}
            nb = {k: float(b[k].norm()) for k in held}
            m = float(np.median(list(nb.values())))
            return [abs(na[k] - nb[k]) / max(nb[k], m) for k in held]

        return {"loss1_rel": loss[0], "loss_rel": max(loss),
                "grad_rel": max(gaps(gg, wg)),
                "delta_rel": max(gaps(gd, wd))}

    @torch.no_grad()
    def check(self) -> dict:
        got = (self.losses, self.grad1,
               {k: self.after[k].to(self.sd0[k].device) - self.sd0[k]
                for k in self.after})
        return self.compare(got, self.reference())
