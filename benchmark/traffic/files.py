"""Albums served from WAV files: the path users take.

Mix parameters: `sr`; a corpus of `corpus` songs whose durations are
spread log-uniformly over [`seconds_min`, `seconds_max`] (the same set
for every seed: the quantiles (i + 1/2) / corpus, dealt to the songs in
a seeded order), written as mono PCM16 WAVs under the run's temporary
directory; requests of `album` songs. One client, closed loop: each
round deals the corpus, in a seeded order, into albums, so every
`corpus / album` requests serve every song once. A request is
`est.predict_files(paths, return_raw=True)`, as the system's command
line serves files; its latency runs from that call until its
predictions return, and a traced run hands every latency of its window
to the readers (`request_p95_ms.files`).

The check compares, for one request drawn from the seed in each run of
`sample_every` requests of the window, and for the window's longest
request (the most audio), the features the request computed and every
clip's raw outputs with the reference working the request out again
from the files; and, for every request of the window, each clip's named
key with the name the reference gives the system's own outputs. Where
the reference stands in the system's place (the control), every request
it serves is compared.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import record_function

from ..readings import Readings
from ..reference import serve as ref_serve
from ..yardstick import profile as prof
from . import common, synth

PROFILED_REQUESTS = 3


class Traffic:
    def __init__(self, ctx):
        self.ctx = ctx
        mix = ctx.mix
        self.sr = mix["sr"]
        self.hop = ref_serve.hop_of(self.sr, ctx.model["frames"])
        n = mix["corpus"]
        lo, hi = mix["seconds_min"], mix["seconds_max"]
        secs = [lo * (hi / lo) ** ((i + 0.5) / n) for i in range(n)]
        order = np.random.default_rng(ctx.sub_seed(3)).permutation(n)
        self.samples = [int(secs[j] * self.sr) for j in order]
        self.rng = np.random.default_rng(ctx.sub_seed(4))
        self.every = 1 if ctx.stand_in else mix["sample_every"]
        self.albums = []
        self.attempted = self.failed = 0
        self.spans = {}

    def next_album(self) -> list:
        if not self.albums:
            order = self.rng.permutation(len(self.samples)).tolist()
            k = self.ctx.mix["album"]
            self.albums = [order[i:i + k] for i in range(0, len(order), k)]
        return self.albums.pop(0)

    def sampled(self, r: int) -> bool:
        """Whether request `r` of the window is one the check compares:
        one drawn from the seed in each run of `every`."""
        k = r // self.every
        return r % self.every == self.ctx.sub_seed(5, k) % self.every

    def setup(self, sd: dict) -> None:
        ctx = self.ctx
        self.sd = sd
        self.dir = Path(tempfile.mkdtemp(prefix="akx-bench-"))
        width = max(self.samples)
        songs = synth.pcm16_batch(self.samples, width, self.sr,
                                  ctx.sub_seed(10), ctx.device).cpu().numpy()
        self.paths = []
        for i, n in enumerate(self.samples):
            path = str(self.dir / f"song{i:03d}.wav")
            synth.write_wav(path, songs[i, :n], self.sr)
            self.paths.append(path)
        os.sync()        # no write-back of the corpus inside the window
        del songs
        self.est = common.estimator(ctx, sd)
        # both buckets an album can pad to: its longest song <= 180 s or not
        by_len = sorted(range(len(self.samples)), key=self.samples.__getitem__)
        k = ctx.mix["album"]
        for album in (by_len[:k], by_len[-k:]):
            self.est.predict_files([self.paths[i] for i in album],
                                   return_raw=True)

    def request(self, album: list):
        return self.est.predict_files([self.paths[i] for i in album],
                                      return_raw=True)

    def window(self, seconds: float, traced: bool = False) -> None:
        est, kept = self.est, {}
        features = est.features
        self.requests = []           # (album, latency s, predictions)
        longest = [-1, 0.0]          # the longest request so far, its minutes

        def keep(batch, sr, hop):
            out = features(batch, sr, hop)
            r = len(self.requests)
            if self.minutes(album) > longest[1]:
                if longest[0] >= 0 and not self.sampled(longest[0]):
                    kept.pop(longest[0], None)
                longest[:] = [r, self.minutes(album)]
            if self.sampled(r) or longest[0] == r:
                kept[r] = out
            return out

        est.features = keep
        restore = self.timed_layers() if traced else (lambda: None)
        t0 = time.perf_counter()
        try:
            while time.perf_counter() - t0 < seconds:
                album = self.next_album()
                self.attempted += 1
                t1 = time.perf_counter()
                try:
                    preds = self.request(album)
                except Exception:     # counted, and never correct
                    self.failed += 1
                    continue
                self.requests.append((album, time.perf_counter() - t1, preds))
            self.window_s = time.perf_counter() - t0
        finally:
            restore()
            del est.features
        self.kept = kept

    def timed_layers(self):
        """Host spans, in a traced run only, around the layers the request
        passes: the decode (`audio_io.decode_many`, as predict_files calls
        it) and the batching with its copy to the device (`make_batch`),
        each ended by a synchronize so that the copy counts where it is
        queued. Returns what undoes them."""
        from audio_key_estimation_torch.data import audio_io
        est, decode = self.est, audio_io.decode_many
        make_batch = est.make_batch
        sync = (torch.cuda.synchronize if self.ctx.device.type == "cuda"
                else (lambda: None))

        def span(layer, fn):
            def run(*a, **kw):
                with record_function(f"bench.{layer}"):
                    t = time.perf_counter()
                    out = fn(*a, **kw)
                    if layer == "decode":
                        out = iter(list(out))
                    sync()
                    self.spans[layer] = self.spans.get(layer, 0.0) \
                        + time.perf_counter() - t
                return out
            return run

        audio_io.decode_many = span("decode", decode)
        est.make_batch = span("batch_h2d", make_batch)

        def restore():
            audio_io.decode_many = decode
            del est.make_batch
        return restore

    def minutes(self, album) -> float:
        return sum(self.samples[i] for i in album) / self.sr / 60.0

    def end_to_end(self) -> dict:
        minutes = sum(self.minutes(a) for a, _, _ in self.requests)
        return {"served_audio_min_per_s": minutes / self.window_s}

    def trace(self) -> Readings:
        albums = [self.next_album() for _ in range(PROFILED_REQUESTS)]
        restore = self.timed_layers()
        spans = dict(self.spans)

        def requests():
            for album in albums:
                with record_function("bench.request"):
                    self.request(album)

        try:
            p = prof.profiled(requests, self.ctx.device)
        finally:
            restore()
            self.spans = spans
        clips = {}
        for album, _, _ in self.requests:
            for i in album:
                clips[self.samples[i]] = clips.get(self.samples[i], 0) + 1
        width = ref_serve.bucket_samples(max(self.samples), self.sr)
        return Readings(
            profile=p, calls=len(albums),
            call_minutes=sum(self.minutes(a) for a in albums),
            geometry=common.geometry(
                self.ctx.model, self.ctx.config["runtime"],
                B=self.ctx.mix["album"], L=width, sr=self.sr, hop=self.hop,
                input_itemsize=2),
            model=self.ctx.model, sr=self.sr, hop=self.hop,
            window_s=self.window_s,
            window_minutes=sum(self.minutes(a) for a, _, _ in self.requests),
            window_clips=clips, spans=self.spans,
            latencies_s=tuple(r[1] for r in self.requests))

    def release(self) -> None:
        del self.est
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, album) -> dict:
        return ref_serve.serve_files(self.sd, self.ctx.model,
                                     [self.paths[i] for i in album],
                                     self.ctx.device)

    @torch.no_grad()
    def check(self) -> dict:
        """cqt, key, tonic: the sampled requests against the reference;
        names: clips of the window whose name differs from the one the
        reference gives the system's own outputs; clips: requests whose
        answers are not one per file."""
        cqt = key = tonic = 0.0
        names = missing = 0
        for r, (album, _, preds) in enumerate(self.requests):
            if len(preds) != len(album):
                missing += 1
                continue
            for p in preds:
                if p.key != ref_serve.key_name(p.key_probs, p.tonic_logits):
                    names += 1
            if r not in self.kept:
                continue
            ref = self.reference(album)
            for got, want in zip(self.kept[r], ref["features"]):
                cqt = max(cqt, common.rel_gap(got[..., 0], want))
            key = max(key, common.abs_gap(
                np.stack([p.key_probs for p in preds]), ref["key"]))
            tonic = max(tonic, common.prob_gap(
                np.stack([p.tonic_logits for p in preds]), ref["tonic"]))
        if not any(r in self.kept for r in range(len(self.requests))):
            cqt = key = tonic = float("inf")
        return {"cqt_rel": cqt, "key_abs": key, "tonic_prob_abs": tonic,
                "names": float(names), "unanswered": float(missing)}

    def close(self) -> None:
        """Remove the corpus."""
        shutil.rmtree(self.dir, ignore_errors=True)
