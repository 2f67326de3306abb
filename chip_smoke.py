#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one CUDA card.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases (each prints a line; any failure raises, so the exit code is
non-zero):
  1 device   require CUDA; print torch, the card and its power limit;
  2 build    compile the hand-written kernels (csrc/*.cu) with nvcc;
  3 kernels  hold each kernel against its plain PyTorch version at the
             serving path's shapes (16 clips x 120 s PCM16 at 22050 Hz;
             the 5->8->8->8 ConvStack at (16, 288, 601)) and time both
             with CUDA events (warm-up, median of 20); then small edge
             geometries (odd B, other rates, n_fft 8192, T = H = 3);
  4 serve    KeyEstimator(Config(fused_convstack=True), seeded weights,
             device="cuda").predict_files on 16 PCM16 WAVs, with every
             kernel's launch count checked, against the plain path
             (use_pallas_cqt="off", fused_convstack=False) on the card
             and, for two 10 s clips, on the CPU;
  5 result   the card line, the kernels JSON line, and the last line
             {"ok": true, "device": {...}}.
Imports only torch, numpy and the port (no JAX).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from audio_key_estimation_torch.config import Config
from audio_key_estimation_torch.data import audio_io
from audio_key_estimation_torch.models import PitchClassNet
from audio_key_estimation_torch.ops import _build
from audio_key_estimation_torch.ops import convstack_cuda as CS
from audio_key_estimation_torch.ops import cqt as C
from audio_key_estimation_torch.ops import cqt_cuda as K
from audio_key_estimation_torch.predict import KeyEstimator

SR = 22050
CLIP_SECONDS = 120
BATCH = 16
REPS = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def clips(n: int = BATCH) -> list[np.ndarray]:
    """The bench corpus recipe (bench.py make_corpus): deterministic
    2-minute two-partial tones plus noise, as the int16 PCM that
    audio_io.write_wav stores."""
    rng = np.random.default_rng(0)
    t = np.arange(SR * CLIP_SECONDS) / SR
    out = []
    for i in range(n):
        f0 = 110.0 * 2 ** (i / 5)
        y = (0.4 * np.sin(2 * np.pi * f0 * t)
             + 0.2 * np.sin(2 * np.pi * f0 * 1.5 * t)
             + 0.05 * rng.normal(size=t.shape)).astype(np.float32)
        out.append(y * 0.5)
    return out


def pcm16(y: np.ndarray) -> np.ndarray:
    return np.round(np.clip(y, -1.0, 1.0) * 32767.0).astype(np.int16)


def time_ms(fn) -> float:
    """Median CUDA-event time of fn over REPS runs after 3 warm-ups."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Max distance in bf16 units in the last place between a and b."""
    def ordered(x):
        i = x.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def check_close(name, got, ref, rtol, atol) -> float:
    err = (got.float() - ref.float()).abs()
    bad = err > atol + rtol * ref.float().abs()
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements beyond "
                             f"rtol {rtol} / atol {atol}; max |d| "
                             f"{float(err.max()):.3g}")
    return float(err.max())


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_cqt_kernels(y: torch.Tensor, p: C.CQTParams) -> dict:
    """Kernels A and B on every octave, f32 and bf16 streams, then the
    whole cqt_cuda against the plain cqt."""
    n_fft = C.kernel_bank(p)["n_fft"]
    head = n_fft // 2
    B, L = y.shape
    n_frames = 1 + L // p.hop
    lens = C.stream_lengths(L, p.octaves)
    in_scale = C.input_scale(y)
    bank_t, starts, scales = K._constants(p, n_frames, in_scale, str(y.device))
    res = {"A": 0.0, "B": 0.0}
    for sd in (torch.float32, torch.bfloat16):
        buf = C.pad_stream(y, head, K.padded_length(L, n_fft))
        chain = [buf]
        for o in range(p.octaves):
            if o > 0:
                args = (buf, head, lens[o - 1], lens[o],
                        K.padded_length(lens[o], n_fft),
                        C.decimation_taps(o, in_scale), sd)
                got = K.cascade_pad(*args)
                ref = K.cascade_pad_plain(*args)
                if sd == torch.float32:
                    err = check_close(f"kernel A f32 octave {o}", got, ref,
                                      1e-5, 1e-6)
                else:
                    ulps = bf16_ulps(got, ref)
                    if ulps > 1:
                        raise AssertionError(
                            f"kernel A bf16 octave {o}: {ulps} ulps")
                    err = float((got.float() - ref.float()).abs().max())
                res["A"] = max(res["A"], err)
                buf = got
                chain.append(buf)
            out = torch.empty(B, p.n_bins, n_frames, device=y.device)
            row0 = (p.octaves - 1 - o) * p.bins_per_octave
            K.octave_response(buf, starts[o], bank_t, scales[o], out, row0)
            ref = K.octave_response_plain(buf, starts[o], bank_t.T,
                                          scales[o])
            got = out[:, row0:row0 + p.bins_per_octave]
            res["B"] = max(res["B"], check_close(
                f"kernel B {sd} octave {o}", got, ref, 1e-4, 1e-4))
        got = K.cqt_cuda(y, p, stream_dtype=sd)
        ref = C.cqt(y, p, stream_dtype=sd)
        if sd == torch.float32:
            err = check_close("cqt_cuda f32", got, ref, 1e-4, 1e-4)
        else:
            err = float((got - ref).abs().max())
            if err > 0.02 * float(ref.abs().max()):
                raise AssertionError(f"cqt_cuda bf16: max |d| {err:.3g} > "
                                     f"2% of peak {float(ref.abs().max())}")
        res[f"cqt_{'f32' if sd == torch.float32 else 'bf16'}"] = err
        log(f"[3 kernels] cqt_cuda vs plain cqt, {sd} streams: "
            f"max|d| {err:.3g} (peak {float(ref.abs().max()):.3f})")

    # timings on the serving configuration: the bf16-stream chain just built

    def run_a(fn):
        def go():
            for o in range(1, p.octaves):
                fn(chain[o - 1], head, lens[o - 1], lens[o],
                   K.padded_length(lens[o], n_fft),
                   C.decimation_taps(o, in_scale), sd)
        return go

    out = torch.empty(B, p.n_bins, n_frames, device=y.device)

    def b_kernel():
        for o in range(p.octaves):
            K.octave_response(chain[o], starts[o], bank_t, scales[o], out,
                              (p.octaves - 1 - o) * p.bins_per_octave)

    def b_plain():
        for o in range(p.octaves):
            K.octave_response_plain(chain[o], starts[o], bank_t.T, scales[o])

    res["A_ms"] = time_ms(run_a(K.cascade_pad))
    res["A_plain_ms"] = time_ms(run_a(K.cascade_pad_plain))
    res["B_ms"] = time_ms(b_kernel)
    res["B_plain_ms"] = time_ms(b_plain)
    res["cqt_ms"] = time_ms(lambda: K.cqt_cuda(y, p, stream_dtype=sd))
    res["cqt_plain_ms"] = time_ms(lambda: C.cqt(y, p, stream_dtype=sd))
    log(f"[3 kernels] A (7 octave steps): max|d| {res['A']:.3g}, "
        f"{res['A_ms']:.3f} ms vs plain {res['A_plain_ms']:.3f} ms")
    log(f"[3 kernels] B (8 octaves): max|d| {res['B']:.3g}, "
        f"{res['B_ms']:.3f} ms vs plain {res['B_plain_ms']:.3f} ms")
    log(f"[3 kernels] whole CQT (bf16 streams): {res['cqt_ms']:.3f} ms vs "
        f"plain {res['cqt_plain_ms']:.3f} ms")
    return res


def check_conv_kernel(device) -> dict:
    """Kernel C on the layer-1 Pitch2Pitch stack 5->8->8->8 at
    (16, 288, 601), same bf16 inputs and weights on both sides."""
    g = np.random.default_rng(1)
    B, H, T = BATCH, 288, 601
    layers = []
    for ci in (5, 8, 8):
        w = g.standard_normal((8, ci, 7, 7)) * (0.5 / np.sqrt(49 * ci))
        s = 1.0 + 0.2 * g.standard_normal(8)
        t = 0.1 * g.standard_normal(8)
        b = 0.1 * g.standard_normal(8)
        layers.append((torch.tensor(w * s[:, None, None, None],
                                    dtype=torch.float32, device=device)
                       .to(torch.bfloat16),
                       torch.tensor(b * s + t, dtype=torch.float32,
                                    device=device)))
    x = torch.tensor(g.standard_normal((B, 5, H, T)), dtype=torch.float32,
                     device=device)
    h = CS.to_channels_last(x, torch.bfloat16)
    res = {"C": 0.0}
    hk = hp = h
    for i, (w, b) in enumerate(layers):
        got = CS.conv7_layer(hk, w, b)
        ref = CS.conv7_layer_plain(hk, w, b)
        res["C"] = max(res["C"], float((got.float() - ref.float())
                                       .abs().max()))
        hk, hp = got, CS.conv7_layer_plain(hp, w, b)
    got, ref = hk.float(), hp.float()
    rel = float((got - ref).abs().max() / ref.abs().max())
    mean_rel = float((got - ref).abs().mean() / ref.abs().mean())
    if not (rel < 5e-2 and mean_rel < 1e-2):
        raise AssertionError(f"kernel C stack: max rel {rel:.3g}, mean rel "
                             f"{mean_rel:.3g}")

    def stack(fn):
        def go():
            z = h
            for w, b in layers:
                z = fn(z, w, b)
        return go

    res["C_ms"] = time_ms(stack(CS.conv7_layer))
    res["C_plain_ms"] = time_ms(stack(CS.conv7_layer_plain))
    log(f"[3 kernels] C (3-layer stack): max|d| per layer {res['C']:.3g}, "
        f"stack max rel {rel:.3g} mean rel {mean_rel:.3g}; "
        f"{res['C_ms']:.3f} ms vs plain {res['C_plain_ms']:.3f} ms")
    return res


def check_edge_geometries(device) -> None:
    """Small shapes off the main path: odd batches, other sample rates
    and bin counts, n_fft 8192 (overlapping windows), streams shorter
    than the reflect pad, float input; kernel C at T = H = 3 and ragged
    tiles. Kernel vs plain at the same bars as the main-path checks."""
    g = np.random.default_rng(2)
    cases = [  # (sr, hop, bins/octave, octaves, B, seconds, int16?)
        (8000, 1600, 12, 3, 3, 2.0, True),
        (22050, 4410, 36, 4, 1, 3.0, False),     # n_fft 8192
        (44100, 8820, 36, 7, 2, 5.3, True),
        (22050, 4410, 36, 8, 5, 0.9, True),      # deep streams < pad
    ]
    for sr, hop, bpo, octaves, B, sec, as_int in cases:
        p = C.CQTParams(sr=sr, hop=hop, bins_per_octave=bpo, octaves=octaves)
        y = g.uniform(-0.6, 0.6, (B, int(sr * sec))).astype(np.float32)
        y = torch.from_numpy(pcm16(y) if as_int else y).to(device)
        for sd in (torch.float32, torch.bfloat16):
            got = K.cqt_cuda(y, p, stream_dtype=sd)
            ref = C.cqt(y, p, stream_dtype=sd)
            if sd == torch.float32:
                check_close(f"cqt_cuda {p} B={B}", got, ref, 1e-4, 1e-4)
            elif float((got - ref).abs().max()) > 0.02 * float(
                    ref.abs().max()):
                raise AssertionError(f"cqt_cuda bf16 {p} B={B}")
    for B, ci, H, T in [(1, 5, 3, 3), (3, 8, 7, 65), (2, 5, 288, 5),
                        (1, 8, 9, 130)]:
        x = torch.tensor(g.standard_normal((B, H, T, 8)), dtype=torch.float32,
                         device=device)
        x[..., ci:] = 0
        x = x.to(torch.bfloat16)
        w = torch.tensor(g.standard_normal((8, ci, 7, 7)) * 0.05,
                         dtype=torch.float32, device=device).to(torch.bfloat16)
        b = torch.tensor(g.standard_normal(8) * 0.1, dtype=torch.float32,
                         device=device)
        ulps = bf16_ulps(CS.conv7_layer(x, w, b), CS.conv7_layer_plain(x, w, b))
        if ulps > 1:
            raise AssertionError(f"kernel C at {(B, ci, H, T)}: {ulps} ulps")
    log(f"[3 kernels] edge geometries: {len(cases)} CQT cases x 2 stream "
        "dtypes and 4 conv7 cases match their plain versions")


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------

def seeded_weights(cfg: Config) -> dict:
    """PitchClassNet weights from torch.Generator seed 0, BatchNorm
    statistics and affines drawn from it too (so the fold is exercised)."""
    g = torch.Generator().manual_seed(0)
    sd = PitchClassNet(cfg, generator=g).state_dict()
    for k, v in sd.items():
        if k.endswith("running_mean"):
            sd[k] = 0.1 * torch.randn(v.shape, generator=g)
        elif k.endswith("running_var"):
            sd[k] = 0.5 + torch.rand(v.shape, generator=g)
    return sd


def serve(paths, device) -> dict:
    cfg = Config(fused_convstack=True)
    weights = seeded_weights(cfg)
    est = KeyEstimator(cfg, weights, device=device)
    plain = KeyEstimator(cfg.replace(use_pallas_cqt="off",
                                     fused_convstack=False),
                         weights, device=device)
    est.predict_files(paths)      # warm-up: allocator, cuDNN, constants
    plain.predict_files(paths)
    counters = (K.cascade_pad, K.octave_response, CS.conv7_layer)
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    preds = est.predict_files(paths, return_raw=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    t0 = time.perf_counter()
    ref = plain.predict_files(paths, return_raw=True)
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    if launches != {"cascade_pad": cfg.octaves - 1,
                    "octave_response": cfg.octaves,
                    "conv7_layer": cfg.conv_layers}:
        raise AssertionError(f"serve did not run every kernel: {launches}")
    if len(preds) != len(paths):
        raise AssertionError(f"{len(preds)} predictions for {len(paths)}")
    key = np.stack([q.key_probs for q in preds])
    key_ref = np.stack([q.key_probs for q in ref])
    tonic = np.stack([q.tonic_logits for q in preds])
    tonic_ref = np.stack([q.tonic_logits for q in ref])
    if key.shape != (len(paths), 12) or not np.isfinite(key).all() \
            or not np.isfinite(tonic).all():
        raise AssertionError(f"bad key probabilities {key.shape}")
    dkey = float(np.abs(key - key_ref).max())
    dtonic = float(np.abs(tonic - tonic_ref).max())
    if dkey >= 3e-2:
        raise AssertionError(f"served key probs differ from plain: {dkey}")
    dcpu = cpu_cross_check(est, weights, cfg)
    audio_min = len(paths) * CLIP_SECONDS / 60.0
    stages = stage_ms(est, paths)
    log(f"[4 serve] {len(preds)} predictions, launches {launches}; key "
        f"|d| vs plain {dkey:.3g}, tonic |d| {dtonic:.3g}; "
        f"e.g. {preds[0].key!r} / plain {ref[0].key!r}; small input vs "
        f"the plain path on the CPU: key |d| {dcpu:.3g}")
    log(f"[4 serve] predict_files wall {wall * 1e3:.1f} ms = "
        f"{audio_min / wall:.1f} audio-min/s; plain path "
        f"{wall_plain * 1e3:.1f} ms = {audio_min / wall_plain:.1f} "
        f"audio-min/s ({card_line()})")
    log("[4 serve] stages (host clock, each ending in a synchronize): "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in stages.items()))
    return {"launches": launches, "key_d": dkey, "tonic_d": dtonic,
            "wall_ms": wall * 1e3, "plain_wall_ms": wall_plain * 1e3}


def cpu_cross_check(est: KeyEstimator, weights, cfg: Config) -> float:
    """Two 10 s clips through the card's kernel path and through the
    plain path on the CPU (an independent device and library stack)."""
    waves = [pcm16(w[:10 * SR]) for w in clips(2)]
    cpu = KeyEstimator(cfg.replace(use_pallas_cqt="off",
                                   fused_convstack=False), weights,
                       device="cpu")
    got = est.predict_waveforms(waves, SR, return_raw=True)
    ref = cpu.predict_waveforms(waves, SR, return_raw=True)
    d = max(float(np.abs(a.key_probs - b.key_probs).max())
            for a, b in zip(got, ref))
    if d >= 3e-2:
        raise AssertionError(f"card kernel path vs CPU plain path: key {d}")
    return d


def stage_ms(est: KeyEstimator, paths) -> dict:
    """Split one predict_files call into decode, batch + H2D, CQT and
    model, each stage ending in torch.cuda.synchronize()."""
    t = [time.perf_counter()]
    decoded = list(audio_io.decode_many(paths))
    t.append(time.perf_counter())
    sr = decoded[0][1]
    batch, seq, hop = est.make_batch([w for w, _ in decoded], sr)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    with torch.inference_mode():
        mel = est.features(batch, sr, hop)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        est.model(mel, seq)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
    names = ("decode", "batch+H2D", "cqt", "model")
    return {n: (b - a) * 1e3 for n, a, b in zip(names, t, t[1:])}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[1 device] torch {torch.__version__} (CUDA {torch.version.cuda}) "
        f"on {torch.cuda.get_device_name(0)}; nvidia-smi: {card}")

    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    log(f"[2 build] {so.name} in {time.perf_counter() - t0:.1f} s")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"[2 build]   {line.strip()}")

    waves = clips()
    y = torch.from_numpy(np.stack([pcm16(w) for w in waves])).to(device)
    p = C.CQTParams(sr=SR, hop=C.reference_hop(SR, Config().frames))
    res = check_cqt_kernels(y, p)
    res.update(check_conv_kernel(device))
    del y
    check_edge_geometries(device)

    with tempfile.TemporaryDirectory() as td:
        paths = []
        for i, w in enumerate(waves):
            paths.append(os.path.join(td, f"smoke_{i}.wav"))
            audio_io.write_wav(paths[-1], w, SR)
        srv = serve(paths, device)

    src = "audio_key_estimation_torch/csrc/"
    tpu = "audio_key_estimation_tpu/ops/"
    n = srv["launches"]
    kernels = [
        {"name": "cqt_decimate (kernel A)", "route": "cuda",
         "source": src + "cqt_decimate.cu",
         "replaces": tpu + "cqt_pallas.py:472",
         "launches": n["cascade_pad"], "max_abs_err": res["A"],
         "ms": res["A_ms"], "plain_ms": res["A_plain_ms"]},
        {"name": "cqt_response (kernel B)", "route": "cuda",
         "source": src + "cqt_response.cu",
         "replaces": tpu + "cqt_pallas.py:163, " + tpu + "cqt_pallas.py:316",
         "launches": n["octave_response"], "max_abs_err": res["B"],
         "ms": res["B_ms"], "plain_ms": res["B_plain_ms"]},
        {"name": "conv7 (kernel C)", "route": "cuda",
         "source": src + "conv7.cu",
         "replaces": tpu + "convstack_pallas.py:91",
         "launches": n["conv7_layer"], "max_abs_err": res["C"],
         "ms": res["C_ms"], "plain_ms": res["C_plain_ms"]},
    ]
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
