"""Device-resident batches: the card's rate once the audio is on it.

Mix parameters: `sr`; `batch` clips a call; `batches` distinct batches,
built on the card at set-up and cycled; clip durations evenly spread
over [`seconds_min`, `seconds_max`] (the same set for every seed, dealt
to the batches and rows in a seeded order), zero-padded to
`bucket_seconds`; the true lengths as the system's batching computes
them (1 + samples // hop).

A call is what the system's `KeyEstimator.outputs` runs after
`make_batch`: `est.features` then `est.model`, with the outputs read
back to the host. The window runs calls back to back until `--seconds`
have passed and each batch has had one. The check holds every call's outputs, and the features of
the first call of each batch, against the reference on the same rows.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from ..readings import Readings
from ..reference import serve as ref_serve
from ..yardstick import profile as prof
from . import common, synth


class Traffic:
    def __init__(self, ctx):
        self.ctx = ctx
        mix, model = ctx.mix, ctx.model
        self.sr = mix["sr"]
        self.hop = ref_serve.hop_of(self.sr, model["frames"])
        self.B, nb = mix["batch"], mix["batches"]
        self.width = int(mix["bucket_seconds"] * self.sr)
        n = self.B * nb
        lo, hi = mix["seconds_min"], mix["seconds_max"]
        samples = [int((lo + (hi - lo) * (i + 0.5) / n) * self.sr)
                   for i in range(n)]
        order = np.random.default_rng(ctx.sub_seed(3)).permutation(n)
        self.lengths = [[samples[j] for j in order[b * self.B:(b + 1) * self.B]]
                        for b in range(nb)]
        self.minutes = [sum(ls) / self.sr / 60.0 for ls in self.lengths]
        self.attempted = self.failed = 0

    def setup(self, sd: dict) -> None:
        ctx = self.ctx
        self.sd = sd
        self.inputs = [synth.pcm16_batch(ls, self.width, self.sr,
                                         ctx.sub_seed(10 + b), ctx.device)
                       for b, ls in enumerate(self.lengths)]
        self.seqs = [torch.tensor([1 + n // self.hop for n in ls],
                                  dtype=torch.int32, device=ctx.device)
                     for ls in self.lengths]
        self.est = common.estimator(ctx, sd)
        for b in range(min(2, len(self.inputs))):
            self.call(b)

    @torch.inference_mode()
    def call(self, b: int) -> tuple:
        feats = self.est.features(self.inputs[b], self.sr, self.hop)
        out = self.est.model(*feats, self.seqs[b])
        return feats, [o.cpu() for o in out]

    def window(self, seconds: float, traced: bool = False) -> None:
        self.outputs, self.kept = [], {}
        nb = len(self.inputs)
        i = 0
        t0 = time.perf_counter()
        while True:
            feats, host = self.call(i % nb)
            self.outputs.append((i % nb, host))
            self.kept.setdefault(i % nb, feats)
            i += 1
            if time.perf_counter() - t0 >= seconds and i >= nb:
                break
        self.window_s = time.perf_counter() - t0
        self.attempted = i * self.B

    def end_to_end(self) -> dict:
        minutes = sum(self.minutes[b] for b, _ in self.outputs)
        return {"device_audio_min_per_s": minutes / self.window_s}

    def trace(self) -> Readings:
        nb = len(self.inputs)

        @torch.inference_mode()
        def calls():
            for b in range(nb):
                with record_function("bench.call"):
                    with record_function("bench.features"):
                        feats = self.est.features(self.inputs[b], self.sr,
                                                  self.hop)
                    with record_function("bench.model"):
                        out = self.est.model(*feats, self.seqs[b])
                    with record_function("bench.readback"):
                        [o.cpu() for o in out]

        p = prof.profiled(calls, self.ctx.device)
        clips = {}
        for b, _ in self.outputs:
            for n in self.lengths[b]:
                clips[n] = clips.get(n, 0) + 1
        return Readings(
            profile=p, calls=nb, call_minutes=sum(self.minutes),
            geometry=common.geometry(self.ctx.model, self.ctx.config["runtime"],
                                     B=self.B, L=self.width, sr=self.sr,
                                     hop=self.hop, input_itemsize=2),
            model=self.ctx.model, sr=self.sr, hop=self.hop,
            window_s=self.window_s,
            window_minutes=sum(self.minutes[b] for b, _ in self.outputs),
            window_clips=clips, spans={})

    def release(self) -> None:
        del self.est
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def close(self) -> None:
        self.inputs = self.kept = None

    def reference(self, b: int) -> tuple:
        return ref_serve.outputs(self.sd, self.ctx.model, self.inputs[b],
                                 self.seqs[b], self.sr, self.hop)

    @torch.no_grad()
    def check(self) -> dict:
        """cqt: features of each batch's first call; key, tonic: every
        call's outputs; against the reference on the same rows."""
        cqt = key = tonic = 0.0
        for b in sorted(self.kept):
            feats, (k_ref, t_ref) = self.reference(b)
            for got, ref in zip(self.kept[b], feats):
                cqt = max(cqt, common.rel_gap(got[..., 0], ref))
            for bb, (k, t) in self.outputs:
                if bb == b:
                    key = max(key, common.abs_gap(k, k_ref.cpu()))
                    tonic = max(tonic, common.prob_gap(t, t_ref.cpu()))
        return {"cqt_rel": cqt, "key_abs": key, "tonic_prob_abs": tonic}
