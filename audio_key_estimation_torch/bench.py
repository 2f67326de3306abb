"""Benchmark of the port's serving path on the card: decode -> batched CQT
-> PitchClassNet, swept over front-end, batch size and dtype.

    python -m audio_key_estimation_torch.bench            # one CUDA card
    python -m audio_key_estimation_torch.bench --device cpu

The PyTorch counterpart of the JAX package's `bench.py`. In order:

  corpus    16 deterministic 120 s clips at 22050 Hz (two partials plus
            noise, seed 0) written as PCM16 WAVs (`audio_io.write_wav`);
  ingest    the corpus read with `audio_io.ingest_batch(out=buf)` into one
            reused pageable int16 buffer: best of 3 after one run that
            warms the page cache (`decode_ms_per_audio_min`);
  batch     16 x ceil(max B / 16) variants of the decoded clips built on
            the device, untimed (gain 0.6 + 0.05 c, noise 0.01 * 32768
            from `torch.Generator(device).manual_seed(1)`, rounded and
            clipped to int16); each B takes the first B rows;
  weights   one state_dict from `build_model(cfg, seed 0 generator)`,
            served by every cell through a `KeyEstimator` of its Config;
  sweep     every front x B x dtype, no cell skipped: front `kernels`
            (`Config(fused_convstack=True)`, kernels A, B and C on the
            card) or `plain` (`use_pallas_cqt="off"`,
            `fused_convstack=False`: the plain CQT and cuDNN stacks);
            dtype float32 (IEEE float32) or bfloat16. A cell that raises
            (out of memory too) records {"error": ...} and the sweep goes
            on. Per cell: the first call alone (`first_call_s`: kernels
            built and warmed), then REPS calls launched back to back,
            each reducing its outputs to one scalar on the device, ended
            by one synchronize and a read of the scalars (`pipeline_ms`,
            `audio_min_per_s`); kernels-front cells record each call's
            launches of kernels A, B and C;
  headline  `value`: the best B of the kernels front at float32 (on the
            CPU, where the kernels do not run, of the plain front);
  split     at the headline geometry, per audio-minute: the CQT alone,
            the model alone on the first 16 clips' features replicated
            to B, the model with kernel C off, the pipeline;
  loop      end to end, measured: `scripts/serving_loop.serving_loop`
            with the headline cell's estimator, a producer thread
            ingesting into two reused buffers while the device runs the
            previous step, at each `--loop_batches` rows a step (the 16
            files taken in turn), `--loop_rows` rows in all (5120: 320
            steps of 16, 20 of 256, several seconds each), with the
            producer's ingest and the consumer's step seconds inside the
            loop, and each distinct step run alone (`serial`: its
            outputs' scalar and its input's checksum), which every step
            of the loop must equal; beside it
            bench.py's figure, min(decode, pipeline);
  mfu       analytic front-end FLOPs (`frontend_flops`) plus the plain
            model's (kernel C off) from `FlopCounterMode`, over the time
            and the H100 peak of the cell's dtype (`mfu_peak` names it);
  baseline  the plain pipeline on the CPU, one clip, float32
            (`vs_baseline`, with the CPU thread count).

Every timed call runs the code serving runs (`est.features`, then
`est.model`) under `torch.inference_mode()` and
`utils/precision.ieee_float32`, as `KeyEstimator.outputs` does; the
process's precision settings are torch's defaults and stay so.

Stdout carries JSON lines only: the report, printed again after every
measurement; the last line is the final report in every outcome (an
exception gives value 0.0 and "error", exit code 0). Diagnostics go to
stderr. Runs on the card by default and, without CUDA, reports an error
unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from audio_key_estimation_torch.config import Config
from audio_key_estimation_torch.data import audio_io
from audio_key_estimation_torch.models import build_model
from audio_key_estimation_torch.ops import convstack_cuda as CS
from audio_key_estimation_torch.ops import cqt_cuda as K
from audio_key_estimation_torch.ops.cqt import (CQTParams, halfband_taps,
                                                kernel_bank, reference_hop,
                                                stream_lengths)
from audio_key_estimation_torch.predict import KeyEstimator
from audio_key_estimation_torch.scripts.harness import card_line, log
from audio_key_estimation_torch.scripts.serving_loop import (make_corpus,
                                                             pipeline,
                                                             reduce,
                                                             serial_sums,
                                                             serving_loop)
from audio_key_estimation_torch.utils.precision import ieee_float32

SR = 22050
CLIP_SECONDS = 120
N_CLIPS = 16                  # decoded source clips
BATCHES = (1024, 512, 256)    # bench.py's REPLICAS_SWEEP (64, 32, 16) x 16
DTYPES = ("float32", "bfloat16")
LOOP_BATCHES = (16, 256)
LOOP_ROWS = 5120              # rows of each loop: 320 steps of 16
REPS = 3
BASELINE_REPS = 2
# NVIDIA H100 SXM published dense peaks (chip_smoke.py phase 3): float32
# runs outside the tensor cores (IEEE float32), bfloat16 on them
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
FRONTS = {"kernels": {"fused_convstack": True},
          "plain": {"use_pallas_cqt": "off", "fused_convstack": False}}
COUNTERS = (K.cascade_pad, K.octave_response, CS.conv7_layer)


def host_ingest(paths, L: int) -> tuple:
    """(the decoded int16 batch, best seconds of 3) of ingest_batch into
    one reused buffer, after one run that warms the page cache."""
    buf = np.empty((len(paths), L), np.int16)
    audio_io.ingest_batch(paths, L, out=buf)
    best = math.inf
    for _ in range(3):
        t0 = time.perf_counter()
        got, _, _ = audio_io.ingest_batch(paths, L, out=buf)
        best = min(best, time.perf_counter() - t0)
    if got is not buf:
        raise RuntimeError("ingest fell back off the raw path")
    return buf, best


def expand(y0: torch.Tensor, variants: int, seed: int = 1) -> torch.Tensor:
    """(variants * n, L) int16 on y0's device: variant c of the n clips
    is y0 * (0.6 + 0.05 c) plus N(0, 0.01 * 32768) noise, rounded and
    clipped (bench.py's _expand)."""
    gen = torch.Generator(y0.device).manual_seed(seed)
    n = y0.shape[0]
    ys = torch.empty((variants * n, y0.shape[1]), dtype=torch.int16,
                     device=y0.device)
    for c in range(variants):
        v = y0.float() * (0.6 + 0.05 * c) + torch.randn(
            y0.shape, generator=gen, device=y0.device) * (0.01 * 32768.0)
        ys[c * n:(c + 1) * n] = v.round_().clamp_(-32768, 32767).to(
            torch.int16)
    return ys


def frontend_flops(p: CQTParams, L: int, batch: int) -> float:
    """Useful FLOPs of the CQT of `batch` clips of L samples, from the
    function's definition (no implementation's tiling): per octave and
    clip, n_frames windows of n_fft samples against bins_per_octave
    complex filters, 2 * 2 * bpo * n_fft * n_frames; per decimated
    output sample, the 49-tap half-band FIR, 2 * 49."""
    n_fft = kernel_bank(p)["n_fft"]
    n_frames = 1 + L // p.hop
    response = 2 * 2 * p.bins_per_octave * n_fft * n_frames * p.octaves
    taps = len(halfband_taps())
    decimation = 2 * taps * sum(stream_lengths(L, p.octaves)[1:])
    return float(batch * (response + decimation))


@torch.inference_mode()
@ieee_float32()
def features_sum(est: KeyEstimator, y, sr: int, hop: int) -> torch.Tensor:
    """The CQT front-end alone, reduced to one scalar on the device."""
    return sum(f.sum() for f in est.features(y, sr, hop))


@torch.inference_mode()
@ieee_float32()
def model_sum(model, feats, seq) -> torch.Tensor:
    """The model alone on given features, reduced to one scalar."""
    return reduce(model(*feats, seq))


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def launch_counts() -> dict:
    return {c.__name__: c.launches for c in COUNTERS}


def time_calls(call, reps: int, device: torch.device) -> dict:
    """The first call alone (its scalar read), then `reps` calls launched
    back to back, ended by one synchronize and a read of their scalars.
    Each call's kernel launches are read as deltas around it."""
    per_call = []

    def counted():
        before = launch_counts()
        out = call()
        after = launch_counts()
        per_call.append({k: after[k] - before[k] for k in after})
        return out

    gc.collect()
    t0 = time.perf_counter()
    counted().item()
    first_s = time.perf_counter() - t0
    gc.collect()
    synchronize(device)
    t0 = time.perf_counter()
    outs = [counted() for _ in range(reps)]
    synchronize(device)
    torch.stack(outs).tolist()
    dt = (time.perf_counter() - t0) / reps
    return {"first_call_s": first_s, "ms": dt * 1e3,
            "launches_per_call": {k: [c[k] for c in per_call]
                                  for k in per_call[0]}}


def estimator(front: str, dtype: str, weights, device) -> KeyEstimator:
    cfg = Config(dtype=dtype, **FRONTS[front])
    return KeyEstimator(cfg, weights, device=device)


def release(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def device_info(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"name": "cpu", "type": "cpu",
                "threads": torch.get_num_threads(), "torch": torch.__version__}
    line = card_line()
    return {"name": torch.cuda.get_device_name(device), "type": "cuda",
            "power_limit": line.split(",")[-1].strip(), "nvidia_smi": line,
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda}


def parse_args(argv):
    def ints(s):
        return [int(v) for v in s.split(",") if v]

    parser = argparse.ArgumentParser(
        description="The port's serving benchmark (one JSON line a "
                    "measurement on stdout, the last one final)")
    parser.add_argument("--device", default="cuda",
                        help="torch device; without CUDA only cpu runs")
    parser.add_argument("--batches", type=ints,
                        default=list(BATCHES), help="clips per call")
    parser.add_argument("--loop_batches", type=ints,
                        default=list(LOOP_BATCHES),
                        help="clips per step of the serving loop")
    parser.add_argument("--loop_rows", type=int, default=LOOP_ROWS,
                        help="rows each serving loop runs, in steps of "
                             "--loop_batches")
    parser.add_argument("--clip_seconds", type=int, default=CLIP_SECONDS)
    return parser.parse_args(argv)


def run(args, report: dict, emit) -> None:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available "
                           "(pass --device cpu to run on the CPU)")
    report["device"] = device_info(device)
    L = SR * args.clip_seconds
    cfg = Config()
    hop = reference_hop(SR, cfg.frames, cfg.window_size, L)
    params = CQTParams(sr=SR, hop=hop, bins_per_octave=cfg.bins_per_octave,
                       octaves=cfg.octaves)
    n_frames = 1 + L // hop
    clip_min = args.clip_seconds / 60.0
    stages = report["stages"]

    with tempfile.TemporaryDirectory() as td:
        paths = make_corpus(td, N_CLIPS, SR, args.clip_seconds)
        y0, decode_s = host_ingest(paths, L)
        decode_tp = N_CLIPS * clip_min / decode_s
        stages["decode_ms_per_audio_min"] = decode_s / (N_CLIPS * clip_min) \
            * 1e3
        log(f"host ingest (PCM16 into one reused buffer): {N_CLIPS} wavs in "
            f"{decode_s * 1e3:.1f} ms ({decode_tp:.1f} audio-min/s)")
        emit()

        ys = expand(torch.from_numpy(y0).to(device),
                    -(-max(args.batches) // N_CLIPS))
        seq_all = torch.full((ys.shape[0],), n_frames, dtype=torch.int32,
                             device=device)
        synchronize(device)
        weights = build_model(cfg, torch.Generator().manual_seed(0)
                              ).state_dict()

        fronts = ["kernels", "plain"]
        if device.type != "cuda":
            report["fronts"]["kernels"] = {"not_run": device.type}
            fronts = ["plain"]
        value, B, pipe_ms = sweep(args, report, emit, fronts, weights, ys,
                                  seq_all, hop)
        audio_min = B * clip_min

        # --- stage split at the headline geometry ---
        est = estimator(fronts[0], "float32", weights, device)
        plain_est = KeyEstimator(est.cfg.replace(fused_convstack=False),
                                 weights, device=device)
        y, seq = ys[:B], seq_all[:B]
        dt_cqt = time_calls(lambda: features_sum(est, y, SR, hop), REPS,
                            device)
        stages["cqt_ms_per_audio_min"] = dt_cqt["ms"] / audio_min
        with torch.inference_mode(), ieee_float32():
            mel = est.features(ys[:min(N_CLIPS, B)], SR, hop)
            mels = tuple(m.repeat(-(-B // m.shape[0]), 1, 1, 1)[:B]
                         for m in mel)
        dt = time_calls(lambda: model_sum(est.model, mels, seq), REPS,
                        device)
        stages["model_ms_per_audio_min"] = dt["ms"] / audio_min
        dt_plain = time_calls(lambda: model_sum(plain_est.model, mels, seq),
                              REPS, device)
        stages["model_plain_ms_per_audio_min"] = dt_plain["ms"] / audio_min
        stages["pipeline_ms_per_audio_min"] = pipe_ms / audio_min
        log(f"split at B={B}: cqt {dt_cqt['ms']:.2f} ms, model "
            f"{dt['ms']:.2f} ms (kernel C off {dt_plain['ms']:.2f} ms), "
            f"pipeline {pipe_ms:.2f} ms")
        emit()

        # --- MFU: analytic front-end FLOPs + the plain model's ---
        with FlopCounterMode(display=False) as fc:
            model_sum(plain_est.model, mels, seq)
        model_flops_per_clip = fc.get_total_flops() / B
        del mels, mel, plain_est
        release(device)
        report["flops_per_clip"] = {
            "frontend": frontend_flops(params, L, 1),
            "model": model_flops_per_clip}
        for front in fronts:
            for dtype, cells in report["fronts"][front].items():
                for name, cell in cells.items():
                    if "pipeline_ms" in cell:
                        b = int(name[1:])
                        flops = (frontend_flops(params, L, b)
                                 + model_flops_per_clip * b)
                        cell["mfu"] = (flops / (cell["pipeline_ms"] / 1e3)
                                       / PEAK_FLOPS[dtype])
        report["mfu"] = report["fronts"][fronts[0]]["float32"][f"b{B}"]["mfu"]
        report["mfu_peak"] = {
            "flops_per_s": PEAK_FLOPS["float32"], "dtype": "float32",
            "of": "NVIDIA H100 SXM, float32 outside the tensor cores"}
        log(f"MFU {report['mfu'] * 100:.3f}% of the H100 float32 peak "
            f"(front-end {report['flops_per_clip']['frontend'] / 1e9:.2f} + "
            f"model {model_flops_per_clip / 1e9:.2f} GFLOP a clip)")
        emit()

        # --- end to end, measured: ingest overlapped with the device ---
        report["end_to_end_min_of_stages"] = min(decode_tp, value)
        report["end_to_end"] = {}
        for lb in args.loop_batches:
            steps = -(-args.loop_rows // lb)
            res = serving_loop(est, paths, L, lb, steps)
            res["ingest_audio_min_per_s"] = (steps * lb * clip_min
                                             / res["ingest_s"])
            # step i reads the files of step i mod (corpus / gcd)
            cycle = min(steps, N_CLIPS // math.gcd(N_CLIPS, lb))
            res["serial"] = serial_sums(est, paths, L, lb, cycle)
            report["end_to_end"][f"b{lb}"] = res
            log(f"serving loop: {steps} steps x {lb} clips in "
                f"{res['wall_s']:.2f} s (ingest {res['ingest_s']:.2f} s, "
                f"steps {res['step_s']:.2f} s) -> "
                f"{res['audio_min_per_s']:.1f} audio-min/s end to end")
            emit()
        first = report["end_to_end"][f"b{args.loop_batches[0]}"]
        report["end_to_end_audio_min_per_s"] = first["audio_min_per_s"]
        del est
        release(device)

    report["baseline"] = cpu_baseline(weights, y0[:1], hop, clip_min)
    report["vs_baseline"] = value / report["baseline"]["audio_min_per_s"]
    log(f"vs_baseline {report['vs_baseline']:.1f}")


def sweep(args, report: dict, emit, fronts, weights, ys, seq_all,
          hop: int):
    """Every front x dtype x B, no cell skipped, each cell's result
    under report["fronts"][front][dtype]["b<B>"]; the headline (`value`,
    `front_end`, `batch_clips`, `dtype`) is the fastest float32 cell of
    fronts[0]. Returns (audio-min/s, B, pipeline ms) of the headline."""
    device = ys.device
    clip_min = args.clip_seconds / 60.0
    best = None
    for front in fronts:
        for dtype in DTYPES:
            cells = report["fronts"].setdefault(front, {}).setdefault(
                dtype, {})
            for b in args.batches:
                cell = cells[f"b{b}"] = run_cell(
                    front, dtype, b, weights, ys, seq_all, hop, device,
                    clip_min)
                tp = cell.get("audio_min_per_s")
                if (front == fronts[0] and dtype == "float32"
                        and tp is not None
                        and (best is None or tp > best[0])):
                    best = (tp, b, cell["pipeline_ms"])
                    report.update(value=tp, front_end=front, batch_clips=b,
                                  dtype=dtype)
                emit()
    if best is None:
        raise RuntimeError(f"every {fronts[0]}-front float32 cell failed: "
                           "no headline")
    return best


def cpu_baseline(weights, y1: np.ndarray, hop: int, clip_min: float) -> dict:
    """The plain pipeline on the CPU in float32, on one decoded clip."""
    cpu = torch.device("cpu")
    est = estimator("plain", "float32", weights, cpu)
    y = torch.from_numpy(y1.copy())
    seq = torch.full((1,), 1 + y.shape[1] // hop, dtype=torch.int32)
    dt = time_calls(lambda: pipeline(est, y, SR, hop, seq), BASELINE_REPS,
                    cpu)
    tp = clip_min / (dt["ms"] / 1e3)
    log(f"cpu baseline: {dt['ms']:.0f} ms a clip ({tp:.2f} audio-min/s, "
        f"{torch.get_num_threads()} threads)")
    return {"ms_per_clip": dt["ms"], "audio_min_per_s": tp,
            "cpu_threads": torch.get_num_threads(),
            "pipeline": "plain, float32, 1 clip, CPU"}


def run_cell(front, dtype, b, weights, ys, seq_all, hop, device,
             clip_min) -> dict:
    """One cell of the sweep: its timing, or {"error": ...}."""
    if b > ys.shape[0]:
        return {"error": f"B={b} > the {ys.shape[0]} rows built"}
    try:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        est = estimator(front, dtype, weights, device)
        y, seq = ys[:b], seq_all[:b]
        t = time_calls(lambda: pipeline(est, y, SR, hop, seq), REPS, device)
    except Exception as e:           # the sweep goes on; the cell says why
        traceback.print_exc(file=sys.stderr)
        release(device)
        return {"error": f"{type(e).__name__}: {e}"[:500]}
    del est
    cell = {"pipeline_ms": t["ms"], "first_call_s": t["first_call_s"],
            "audio_min_per_s": b * clip_min / (t["ms"] / 1e3)}
    if front == "kernels":
        cell["launches_per_call"] = t["launches_per_call"]
    if device.type == "cuda":
        cell["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    release(device)
    log(f"{front:7s} {dtype:8s} B={b}: first call {t['first_call_s']:.2f} s, "
        f"pipeline {t['ms']:.2f} ms -> {cell['audio_min_per_s']:.1f} "
        f"audio-min/s")
    return cell


def main(argv=None) -> int:
    args = parse_args(argv)
    report = {"metric": "audio_min_per_sec_per_chip", "value": 0.0,
              "unit": "audio-min/s/chip", "vs_baseline": 0.0,
              "clip_seconds": args.clip_seconds,
              "sweep": {"batches": args.batches, "dtypes": list(DTYPES),
                        "reps": REPS, "loop_rows": args.loop_rows},
              "stages": {}, "fronts": {}}

    def emit():
        print(json.dumps(report), flush=True)

    try:
        run(args, report, emit)
    except Exception as e:      # the report's last line says what failed
        traceback.print_exc(file=sys.stderr)
        report["value"] = 0.0
        report["error"] = f"{type(e).__name__}: {e}"[:500]
    emit()
    return 0


if __name__ == "__main__":
    sys.exit(main())
