#!/usr/bin/env python3
"""Drive the PyTorch port's serving, dataset and training paths once on one
CUDA card.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases (each prints a line; any failure raises, so the exit code is
non-zero):
  1 device   require CUDA; print torch, the card and its power limit;
  2 build    compile the hand-written kernels (csrc/*.cu, nvcc) and their
             operator bindings (csrc/bindings.cpp, the host compiler
             against torch's headers), load them as torch.ops.akt and
             list the registered operators; build the host audio library
             (native/*.cpp, the host compiler);
  3 kernels  hold each kernel against its plain PyTorch version at the
             serving path's shapes (16 clips x 120 s PCM16 at 22050 Hz:
             kernel A's 7 octave steps into the stream arena, kernel B's
             one launch over all 8 octaves; kernel C per layer and the
             served function fused_convstack, 5->8->8->8 from float32
             NCHW to float32 NCHW at (16, 288, 601), also at T = 901 and
             each layer alone) and time both with CUDA events
             (warm-up, median of 20; kernels A, B, C also replayed from a
             CUDA graph, the card's time without the host's), beside the
             library call that computes the
             same function where there is one, and the bound from the
             shapes (bytes over 3.35 TB/s or operations over the peak of
             their type); then small edge geometries (odd B, other rates,
             12 bins x 8 octaves, n_fft 8192, T = H = 3, kernel C at 1
             input channel and H = 96 and in every layout and dtype);
  3o oracle  the kernels' served CQT (ops/frontend.compute_cqt: A and B)
             against the float64 oracles computed on the card
             (ops/cqt_oracle.py, ops/librosa_ref.py), per octave, on
             phase 3's 16 x 120 s PCM16 clips and on 16 clips of the JAX
             tests' signal class: (a) the direct oracle at 36 and 12
             bins x 8 octaves, hop 4410; (b) the librosa algorithm at
             the JAX tests' geometries (hop 4416: 36 x 6, 12 x 5, 36 x
             4); (c) at 8 octaves, hop 4352; (d) the default model
             served through A, B and C (predict_waveforms) and through
             the plain path against the oracle's log1p CQT into a
             float64 copy of the model. The JAX bars hold the kernels,
             except where the plain path misses as much (recorded in
             REFERENCE_MISSES): there, and in (c), the plain path's
             distance plus 1e-3 of the octave's peak (3e-2 for logits);
  4 serve    KeyEstimator(Config(fused_convstack=True, ...), seeded
             weights with measured BatchNorm statistics, device="cuda")
             .predict_files on 16 PCM16 WAVs for the default model, every
             model variant (res/dense blocks, p2pc_conv, pc2p_mem,
             stay_sixth, only_semitones, max_pool, three layers, two
             combinations), the bf16 model and the multi-scale ensemble
             (averaging, and linear_reg_multi with genre: two CQTs at 36
             and 12 bins/octave, kernel C on model1's stack at H = 288
             and model2's at H = 96), at the default widths: launches
             checked against the gate (A 7, B 1 per CQT, C 0, 1, 3 or
             6); the served batch's own CQTs and kernel C stacks held
             against their plain versions; keys, tonics and the keys' spread
             against the plain path (use_pallas_cqt="off",
             fused_convstack=False) on the card, keys on the CPU for two
             10 s clips; wall beside the plain path's and kernel C's share
             of the model stage (torch.profiler; for the ensemble each
             tower's split too); for the default the stage split; then
             local mode, the default and the averaging ensemble
             (predict_files_local: windows per clip and the first
             window's span, launches, the same holds against the plain
             local path); then one default-model
             batch of PCM16, float32 and 24-bit WAVs (a float32 batch
             through A, B and C), held the same way;
  4b batch   the default model serving distinct clips through
             KeyEstimator.predict_waveforms (predict_files after decode)
             at B = 64, 256, 1024 in the 180 s bucket, 256 in the 60 s
             and 64, 256 in the 420 s bucket: launches A 7 / B 1 / C 3;
             peak device memory per batch and clip, the host's
             MemAvailable, wall, pack + H2D, CQT and model ms,
             audio-min/s; the first and last 16 rows served again in
             batches of 16, and at those rows the batch's CQT and kernel
             C stack against their plain versions and the keys against
             the plain path; each kernel's card ms at that B beside its
             bound;
  5 dataset  KeyDataset.import_data on corpora written with
             data/synthetic.py: 48 songs in 3 groups of 16 (120 s PCM16
             at 44.1 kHz; 120 s float32 and 24-bit WAV at 44.1 kHz with
             float32 streams and the multi_scale 12-bin CQT; 60-420 s at
             22050 Hz in mixed encodings with local labels), each imported
             with the kernels and with the plain CQT on the card: A 7 and
             B 1 launches per group and bins/octave, every mel held at
             check_cqt's bars, labels and batches() equal; 4 songs in
             window_size mode (frames == 0) the same way; the feature
             cache written (`_cuda` sidecars) and read back with no
             launch; walls split into decode, pack + H2D, CQT and labels;
  6 train    training and evaluation at the full widths of the default
             Config and of the averaging multi-scale ensemble, each on
             the same 64 training and 16 validation songs (120 s PCM16 at
             22050 Hz, data/synthetic.py scale walks) imported through
             kernels A and B (the ensemble's mel2 a second CQT per
             group): Trainer.fit for 3 epochs (batch 8 x acc_grad 8,
             T = 601 in the 1024 bucket, fused_convstack on, the epoch -1
             evaluation, checkpoints), kernel C 3 (ensemble 6) times per
             validation batch and never in a train step; one train step
             held against the CPU's (loss, gradients, BatchNorm
             statistics); the validation through kernel C held against
             the plain path (keys, tonics, val_loss, MIREX categories);
             one batch repeated for 10 steps (the loss must fall; step
             wall, peak memory, the step's device split by
             torch.profiler); the best checkpoint served back through
             KeyEstimator.from_checkpoint within 1e-3 of the trainer's
             own eval outputs; then "remat" lines: one train step of the
             denseblock variant with dropout 0.2 and of the default
             model with remat against one without (loss, gradients,
             BatchNorm statistics updated once, every dropout mask drawn
             again alike in the recomputation, wall, peak memory);
  4p precision  (run after phase 6, whose corpus it uses) no precision
             is set for the process, so every phase runs under torch's
             defaults, where cuDNN computes float32 convolutions as
             TF32: the default, resblock and bf16 models' forward on
             phase 4's batch, the dataset's plain CQT and one train step
             of 64 songs, each computed directly with TF32 allowed and
             in IEEE float32 (|d| against the float32 bars, ms both
             ways); then KeyEstimator.outputs, train_step, eval_step and
             KeyDataset._features with TF32 allowed globally must give
             the IEEE numbers (utils/precision.ieee_float32), each
             logging once the settings it was called under;
  6b dp     data parallelism on the one card: KeyEstimator(mesh=
             make_mesh(devices=[cuda:0, cuda:0])) serves 16 and 15 clips
             (one zero pad row) through the default model and 16 through
             the averaging ensemble, two replicas, each shard's CQT and
             model launched before any read-back: launches twice one
             batch's (A 14 / B 2 / C 6; ensemble 28 / 4 / 12), each
             shard's own CQTs and kernel C stacks held against their plain
             versions, keys and tonics within rtol 2e-4 / atol 2e-5 of the
             unsharded kernel path; a wall clock over one sharded call,
             trace() of one sharded batch naming the akt operators and
             its akx.request span;
             Trainer.fit at world 1 on NCCL (file:// store) equal to the
             fit without a group; two spawned ranks on gloo (NCCL refuses
             two ranks on one device): one train step of 8 x 2 songs (4
             rows a rank) against one process (loss, gradients, BatchNorm
             statistics, parameters after Adam, ranks equal), the step's
             wall and all-reduce rows under torch.profiler, and
             evaluate(sharded=True) over the 16 validation songs through
             kernel C against one process's; a rank that fails or
             outlives its join limit fails the run;
  7 probes   the probe and experiment kernels (ops/probes_cuda.py and
             kernel B's stage split) against their plain versions at a
             small geometry and at the serving geometry, exact for the
             copies, each also replayed from a CUDA graph (the card's
             time; #8 beside torch.ones'); #5's six variants also at
             B = 13, each variant's card ms and GB/s; #7 also at
             B = 256 x 120 s, B = 40 and on a view y[:, 1:], timed at
             B = 16 and 256 beside y.t().contiguous() (transpose only,
             no pad: not the same function); then each probe
             entry point
             (audio_key_estimation_torch/scripts/) driven once at the
             serving geometry, every probe kernel's launch count checked;
  7b bench  `python -m audio_key_estimation_torch.bench --batches 256
             --loop_batches 12 --loop_rows 2400` in a subprocess, its
             JSON report printed: both fronts at B = 256 in float32 and
             bf16, the stage split, the serving loop (200 steps of 12 of
             the 16 files, so each reused buffer is rewritten with other
             files), MFU, the CPU baseline. Fails on any error, a
             kernels-front cell whose calls did not each launch A 7 /
             B 1 / C 3, a value <= 0, an MFU outside (0, 1], a loop step
             whose input checksum is not the same step's run alone on
             the card (`serial`) or whose scalar is not within rtol 1e-5
             of it, or a loop whose measured
             end to end beats its own producer's ingest rate or whose
             consumer's steps add up to more than its wall;
  8 converge the hard benchmark's global phase as
             scripts/train_converge_hard.py runs it (run_phase): 240 + 48
             polyphonic songs of 60 s rendered by a process pool,
             imported through kernels A and B (A 7 / B 1 per group), the
             default widths trained up to 30 epochs after the epoch -1
             evaluation (kernel C 3 per validation batch, 0 per train
             step); untrained val MIREX < 0.2, best >= 0.9, the report
             parsed back to the history; the per-epoch MIREX, render,
             preprocess and fit walls beside the card line;
  9 result   the card line, the kernels JSON line, and the last line
             {"ok": true, "device": {...}}.
Imports only torch, numpy and the port (no JAX).
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import logging
import os
import re
import struct
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.nn.functional as F

from audio_key_estimation_torch.config import Config
from audio_key_estimation_torch.data import audio_io, loaders, synthetic
from audio_key_estimation_torch.data.dataset import KeyDataset
from audio_key_estimation_torch.data.dataset import \
    cache_path as dataset_cache_path
from audio_key_estimation_torch.models import blocks, build_model
from audio_key_estimation_torch.models.blocks import BatchNorm, ConvStack
from audio_key_estimation_torch.models.convert import load_state_dict
from audio_key_estimation_torch.native import binding
from audio_key_estimation_torch.ops import _build
from audio_key_estimation_torch.ops import convstack_cuda as CS
from audio_key_estimation_torch.ops import cqt as C
from audio_key_estimation_torch.ops import cqt_cuda as K
from audio_key_estimation_torch.ops import equivariant
from audio_key_estimation_torch.ops.cqt_oracle import oracle_cqt
from audio_key_estimation_torch.ops.librosa_ref import librosa_cqt
from audio_key_estimation_torch.ops.frontend import (compute_cqt,
                                                     feature_bins,
                                                     torch_dtype)
from audio_key_estimation_torch.ops import probes_cuda as PC
from audio_key_estimation_torch.ops import resstack_cuda as RS
from audio_key_estimation_torch.ops import stack_kernels as SK
from audio_key_estimation_torch.parallel.mesh import (init_data_parallel,
                                                      make_mesh, rank_rows)
from audio_key_estimation_torch.predict import KeyEstimator, key_name
from audio_key_estimation_torch.scripts import (experiment_transpose_kernel,
                                                probe_cqt_kernel_stages,
                                                probe_dma_rate,
                                                probe_pallas_overhead,
                                                probe_pallas_primitives,
                                                train_converge_hard)
from audio_key_estimation_torch.scripts.harness import (card_line,
                                                        graph_ms, time_ms)
from audio_key_estimation_torch.train import trainer as T
from audio_key_estimation_torch.train.loss import compute_loss
from audio_key_estimation_torch.train.metrics import mirex_categories
from audio_key_estimation_torch.utils.key_signatures import KEY_SIGNATURE_MAP
from audio_key_estimation_torch.utils import precision
from audio_key_estimation_torch.utils.precision import ieee_float32
from audio_key_estimation_torch.utils.profiling import trace

SR = 22050
CLIP_SECONDS = 120
BATCH = 16


def log(msg: str) -> None:
    print(msg, flush=True)


def clips(n: int = BATCH, seconds: int = CLIP_SECONDS) -> list[np.ndarray]:
    """The bench corpus recipe (bench.py make_corpus): deterministic
    two-partial tones plus noise (2 minutes unless `seconds` says), as
    the int16 PCM that audio_io.write_wav stores."""
    rng = np.random.default_rng(0)
    t = np.arange(SR * seconds) / SR
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


def bf16_ulp_map(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance in bf16 units in the last place between a and b."""
    def ordered(x):
        i = x.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Max distance in bf16 units in the last place between a and b."""
    return int(bf16_ulp_map(a, b).max())


def check_conv7(name, got, ref, x, wp, nchw_in, nchw_out) -> dict:
    """Kernel C's result against its plain version on the same inputs:
    within 1 bf16 ulp, except where the layer's float32 sum cancels: the
    kernel and cuDNN add the same products in other orders, each within
    n u S of the exact sum (n = 49 ci products, u = 2^-24, S the sum of
    their absolute values), so an element may differ by 2 n u S plus one
    ulp, which is many ulps of a result near zero. S comes from the plain
    version on |x| and |w|."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(ref.shape)} {ref.dtype}")
    ulps = bf16_ulp_map(got.to(torch.bfloat16), ref.to(torch.bfloat16))
    beyond = ulps > 1
    if bool(beyond.any()):
        n = 49 * (x.shape[1] if nchw_in else 8)
        s = CS.conv7_layer_plain(x.abs(), wp.abs(), torch.zeros(
            8, device=x.device), nchw_in, nchw_out).float()
        d = (got.float() - ref.float()).abs()
        allowed = 2.0 ** -7 * ref.float().abs() + 2 * n * 2.0 ** -24 * 1.01 * s
        if bool((d > allowed)[beyond].any()):
            raise AssertionError(f"{name}: {int(beyond.sum())} elements "
                                 f"beyond 1 bf16 ulp, some beyond the "
                                 f"float32 sum bound; max |d| "
                                 f"{float(d.max()):.3g}")
    return {"max_ulps": int(ulps.max()), "beyond_1ulp": int(beyond.sum()),
            "max_abs_err": float((got.float() - ref.float()).abs().max())}


def check_close(name, got, ref, rtol, atol) -> float:
    err = (got.float() - ref.float()).abs()
    bad = err > atol + rtol * ref.float().abs()
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements beyond "
                             f"rtol {rtol} / atol {atol}; max |d| "
                             f"{float(err.max()):.3g}")
    return float(err.max())


def check_cqt(name, got, ref, stream_dtype) -> float:
    """cqt_cuda (kernels A and B) against the plain cqt on the same input:
    within rtol/atol 1e-4 with float32 streams; with bf16 streams, which
    each side rounds at other points of the cascade, within 2% of the
    peak."""
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: {tuple(got.shape)} vs "
                             f"{tuple(ref.shape)}")
    if stream_dtype == torch.float32:
        return check_close(name, got, ref, 1e-4, 1e-4)
    err = float((got - ref).abs().max())
    if err > 0.02 * float(ref.abs().max()):
        raise AssertionError(f"{name}: max |d| {err:.3g} > 2% of peak "
                             f"{float(ref.abs().max())}")
    return err


def check_stack(name, x, layers) -> dict:
    """Kernel C on each layer of one stack from x (B, ci, H, T), each
    layer within check_conv7's bars of its plain version on the layer's
    own input; the layers chained equal to fused_convstack, which must
    give (B, 8, H, T) in x's dtype within 5% (max) and 1% (mean) of the
    plain stack, relative to its largest and its mean magnitude."""
    wp, bias = CS.pack_stack(layers)
    n = len(layers)
    h, inputs, checks = x, [], []
    for i in range(n):
        kw = dict(nchw_in=i == 0, nchw_out=x.dtype if i == n - 1 else None)
        got = CS.conv7_layer(h, wp[i], bias[i], **kw)
        ref = CS.conv7_layer_plain(h, wp[i], bias[i], **kw)
        checks.append(check_conv7(f"{name} layer {i}", got, ref, h, wp[i],
                                  **kw))
        inputs.append(h)
        h = got
    stack = CS.fused_convstack(x, layers)
    if stack.dtype != x.dtype or stack.shape != (x.shape[0], 8,
                                                 *x.shape[2:]) \
            or not torch.equal(stack, h):
        raise AssertionError(f"{name}: fused_convstack differs from its "
                             "layers")
    ref = CS.fused_convstack_plain(x, layers).float()
    d = (stack.float() - ref).abs()
    rel = float(d.max() / ref.abs().max())
    mean_rel = float(d.mean() / ref.abs().mean())
    if not (rel < 5e-2 and mean_rel < 1e-2):
        raise AssertionError(f"{name}: stack max rel {rel:.3g}, mean rel "
                             f"{mean_rel:.3g}")
    return {"layers": checks, "inputs": inputs, "wp": wp, "bias": bias,
            "rel": rel, "mean_rel": mean_rel,
            "max_abs_err": max(c["max_abs_err"] for c in checks),
            "beyond_1ulp": sum(c["beyond_1ulp"] for c in checks)}


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

# NVIDIA H100 SXM published peaks
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12          # float32 outside the tensor cores
TF32_FLOPS = 495e12        # TF32 tensor cores, dense
BF16_FLOPS = 989e12        # bf16 tensor cores, dense


def tf32_products(dtype: torch.dtype) -> int:
    """TF32 products kernel B issues per multiply-add of a stream of this
    dtype to keep float32 accuracy (3xTF32): a bf16 sample is exact in
    TF32, so x * b_hi + x * b_lo; an int16 or float32 sample is split too,
    adding x_lo * b_hi."""
    return 2 if dtype == torch.bfloat16 else 3


def bound(nbytes: float, flops: float = 0.0,
          peak: float = F32_FLOPS) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate of their type, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def share(r: dict, key: str) -> str:
    b = r[key + "_bound_ms"]
    return (f"bound {b:.4f} ms ({r[key + '_bound_by']}), "
            f"{b / r[key + '_card_ms']:.1%} of it on the card, "
            f"{b / r[key + '_ms']:.1%} eager")


def put_bound(res: dict, key: str, b: dict) -> None:
    res[key + "_bound_ms"], res[key + "_bound_by"] = b["bound_ms"], \
        b["bound_by"]


def window_cover(starts, n_fft: int) -> int:
    """Samples the windows [s, s + n_fft) of ascending starts cover."""
    st = np.asarray(starts, np.int64)
    return int(n_fft + np.minimum(np.diff(st), n_fft).sum())


def cqt_bounds(y, p, lay, stream_dtype, starts) -> tuple[dict, dict]:
    """Bounds of kernel A's 7 steps and of kernel B's launch at this
    geometry: A reads each interior once and writes each padded stream
    (49 float32 multiply-adds per computed row, outside the tensor
    cores); B reads the samples the windows cover, the bank's two parts
    and the tables, writes the features, and does the GEMM (2bpo * n_fft
    multiply-adds per frame) as the TF32 products it must issue for
    float32 accuracy (tf32_products), at the TF32 peak."""
    n_fft = C.kernel_bank(p)["n_fft"]
    head = n_fft // 2
    B = y.shape[0]
    T = starts.shape[1]
    item = torch.tensor([], dtype=stream_dtype).element_size()
    steps = []
    for o in range(1, p.octaves):
        nbytes = B * lay.lens[o - 1] * (y.element_size() if o == 1
                                        else item) + B * lay.lengths[o] * item
        steps.append((nbytes, 2 * 49 * B * (lay.lens[o] + 2 * head + 1)))
    a_bytes, a_flops = map(sum, zip(*steps))
    b_bytes = 2 * n_fft * 72 * 4 + starts.numel() * 4 \
        + p.octaves * p.bins_per_octave * 4 + B * p.n_bins * T * 4
    for o in range(p.octaves):
        b_bytes += B * window_cover(starts[o].tolist(), n_fft) * (
            y.element_size() if o == 0 else item)
    b_flops = 2 * B * T * 2 * p.bins_per_octave * n_fft * (
        tf32_products(y.dtype) + (p.octaves - 1) * tf32_products(stream_dtype))
    a = bound(a_bytes, a_flops)
    # each step's bytes and FMA times (ms), what its card time is set against
    a["steps"] = [(nb / HBM_BYTES_PER_S * 1e3, nf / F32_FLOPS * 1e3)
                  for nb, nf in steps]
    return a, bound(b_bytes, b_flops, TF32_FLOPS)


@ieee_float32()
def check_cqt_kernels(y: torch.Tensor, p: C.CQTParams) -> dict:
    """Kernel A on every octave step and kernel B's one launch on every
    octave, f32 and bf16 streams from int16 clips, each against its plain
    version on the same inputs; then the whole cqt_cuda against the plain
    cqt. Times, bounds and the library yardsticks on the serving
    configuration (bf16 streams). The plain versions and the yardsticks
    compute float32 in IEEE float32 (TF32 off, scoped to this call)."""
    n_fft = C.kernel_bank(p)["n_fft"]
    head = n_fft // 2
    B, L = y.shape
    n_frames = 1 + L // p.hop
    lay = K.arena_layout(L, p.octaves, n_fft)
    in_scale = C.input_scale(y)
    c = K._constants(p, n_frames, in_scale, str(y.device))
    bpo = p.bins_per_octave
    res = {"A": 0.0, "B": 0.0}
    x0 = C.pad_stream(y, head, lay.lengths[0])
    for sd in (torch.float32, torch.bfloat16):
        arena = K.cascade_arena(x0, lay, head, in_scale, sd)
        streams = K.octave_streams(x0, arena, lay)
        for o in range(1, p.octaves):
            got = streams[o]
            ref = K.cascade_pad_plain(streams[o - 1], head, lay.lens[o - 1],
                                      lay.lens[o], lay.lengths[o],
                                      C.decimation_taps(o, in_scale), sd)
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
        out = torch.full((B, p.n_bins, n_frames), float("nan"),
                         device=y.device)
        K.octave_response(x0, arena, lay, c.starts, c.bank, c.scales, out)
        ref = torch.empty_like(out)
        K.octave_response_arena_plain(x0, arena, lay, c.starts, c.bank,
                                      c.scales, ref)
        errs = []
        for o in range(p.octaves):
            rows = slice((p.octaves - 1 - o) * bpo, (p.octaves - o) * bpo)
            errs.append(check_close(f"kernel B {sd} octave {o}", out[:, rows],
                                    ref[:, rows], 1e-4, 1e-4))
        res["B"] = max(res["B"], *errs)
        ref = C.cqt(y, p, stream_dtype=sd)
        err = check_cqt(f"cqt_cuda {sd}", K.cqt_cuda(y, p, stream_dtype=sd),
                        ref, sd)
        res[f"cqt_{'f32' if sd == torch.float32 else 'bf16'}"] = err
        log(f"[3 kernels] {sd} streams: kernel B max|d| per octave "
            + ", ".join(f"{e:.3g}" for e in errs)
            + f"; cqt_cuda vs plain cqt max|d| {err:.3g} "
            f"(peak {float(ref.abs().max()):.3f})")

    # timings on the serving configuration: the bf16-stream arena above

    def a_steps(fn):
        def go():
            for o in range(1, p.octaves):
                fn(streams[o - 1], head, lay.lens[o - 1], lay.lens[o],
                   streams[o], C.decimation_taps(o, in_scale))
        return go

    def a_plain():
        for o in range(1, p.octaves):
            K.cascade_pad_plain(streams[o - 1], head, lay.lens[o - 1],
                                lay.lens[o], lay.lengths[o],
                                C.decimation_taps(o, in_scale), sd)

    # library yardstick of A: one stride-2 conv1d per step on the
    # zero-padded interior (no reflect rows), in the stream's dtype
    # (octave 0's int16 converted to float32 beforehand)
    conv_in = []
    for o in range(1, p.octaves):
        src = streams[o - 1][:, head:head + lay.lens[o - 1]]
        src = src.float() if src.dtype == torch.int16 else src
        taps = torch.as_tensor(C.decimation_taps(o, in_scale),
                               device=y.device).to(src.dtype)
        conv_in.append((torch.nn.functional.pad(src, (24, 24))[:, None]
                        .contiguous(), taps[None, None]))

    def a_library():
        for xi, w in conv_in:
            torch.nn.functional.conv1d(xi, w, stride=2)

    # GEMM-only yardstick of B: every octave's frames pre-gathered, one
    # float32 cuBLAS product with the [cos|sin] bank (TF32 off)
    idx = c.starts.long()[..., None] + torch.arange(n_fft, device=y.device)
    frames = torch.stack([s[:, idx[o]].float()
                          for o, s in enumerate(streams)])
    bank = c.bank.t.T.contiguous()

    # ms: one eager call, CUDA events (as plain_ms and library_ms);
    # card_ms: the same launches replayed from a CUDA graph
    res["A_ms"] = time_ms(a_steps(K.cascade_pad))
    res["A_card_ms"] = graph_ms(a_steps(K.cascade_pad))
    res["A_step_ms"] = [graph_ms(lambda o=o: K.cascade_pad(
        streams[o - 1], head, lay.lens[o - 1], lay.lens[o], streams[o],
        C.decimation_taps(o, in_scale))) for o in range(1, p.octaves)]
    res["A_plain_ms"] = time_ms(a_plain)
    res["A_library_ms"] = time_ms(a_library)
    del conv_in
    res["B_ms"] = time_ms(lambda: K.octave_response(
        x0, arena, lay, c.starts, c.bank, c.scales, out))
    res["B_card_ms"] = graph_ms(lambda: K.octave_response(
        x0, arena, lay, c.starts, c.bank, c.scales, out))
    res["B_plain_ms"] = time_ms(lambda: K.octave_response_arena_plain(
        x0, arena, lay, c.starts, c.bank, c.scales, ref))
    res["B_gemm_only_ms"] = time_ms(lambda: torch.matmul(frames, bank))
    del frames
    res["cqt_ms"] = time_ms(lambda: K.cqt_cuda(y, p, stream_dtype=sd))
    res["cqt_plain_ms"] = time_ms(lambda: C.cqt(y, p, stream_dtype=sd))
    ba, bb = cqt_bounds(y, p, lay, sd, c.starts)
    put_bound(res, "A", ba)
    put_bound(res, "B", bb)
    log(f"[3 kernels] A (7 octave steps): max|d| {res['A']:.3g}, "
        f"{res['A_ms']:.4f} ms eager (with the host's wrapper calls), "
        f"{res['A_card_ms']:.4f} on the card vs plain "
        f"{res['A_plain_ms']:.4f} ms, library conv1d x 7 "
        f"{res['A_library_ms']:.4f} ms; {share(res, 'A')}"
        "; per step card / bytes / FMA ms " + ", ".join(
            f"{t:.4f} / {b:.4f} / {f:.4f}"
            for t, (b, f) in zip(res["A_step_ms"], ba["steps"])))
    log(f"[3 kernels] B (8 octaves, one launch): max|d| {res['B']:.3g}, "
        f"{res['B_ms']:.4f} ms eager, {res['B_card_ms']:.4f} on the card "
        f"vs plain {res['B_plain_ms']:.4f} ms, "
        f"library none (GEMM only, cuBLAS f32: "
        f"{res['B_gemm_only_ms']:.4f} ms); {share(res, 'B')}")
    log(f"[3 kernels] whole CQT (bf16 streams): {res['cqt_ms']:.4f} ms vs "
        f"plain {res['cqt_plain_ms']:.4f} ms")
    return res


def conv_layers(g: np.random.Generator, device, cins=(5, 8, 8)) -> list:
    """Folded float32 (weight (8, ci, 7, 7), bias (8,)) per layer, with a
    BatchNorm-like scale and shift drawn from g."""
    layers = []
    for ci in cins:
        w = g.standard_normal((8, ci, 7, 7)) * (0.5 / np.sqrt(49 * ci))
        s = 1.0 + 0.2 * g.standard_normal(8)
        t = 0.1 * g.standard_normal(8)
        b = 0.1 * g.standard_normal(8)
        layers.append((torch.tensor(w * s[:, None, None, None],
                                    dtype=torch.float32, device=device),
                       torch.tensor(b * s + t, dtype=torch.float32,
                                    device=device)))
    return layers


def layer_bytes(B: int, H: int, T: int, cin: int, n: int) -> list[int]:
    """What each of the n >= 2 layers of fused_convstack must move: the
    first reads the float32 NCHW input and writes bf16 channels-last, the
    middle ones read and write bf16 channels-last, the last writes the
    float32 NCHW output."""
    per_pos = [cin * 4 + 16] + [16 + 16] * (n - 2) + [16 + 8 * 4]
    return [B * H * T * p for p in per_pos]


def stack_bytes(B: int, H: int, T: int, cin: int, n: int) -> int:
    """What fused_convstack must move: the float32 NCHW input read once,
    each bf16 channels-last intermediate written once and read once, the
    float32 NCHW output written once."""
    return B * H * T * (cin * 4 + (n - 1) * 2 * 8 * 2 + 8 * 4)


@ieee_float32()
def check_conv_kernel(device) -> dict:
    """Kernel C on the layer-1 Pitch2Pitch stack 5->8->8->8 at
    (16, 288, 601): each layer within 1 bf16 ulp of its plain version on
    the same inputs (NCHW float32 in, channels-last bf16 between, NCHW
    float32 out), the stack against the plain stack; the served function
    fused_convstack timed from its float32 NCHW input to its float32
    output, beside each layer alone, the 180 s bucket (T = 901) and
    cuDNN's bf16 conv2d. The plain stack in IEEE float32 (TF32 off,
    scoped to this call)."""
    g = np.random.default_rng(1)
    B, H, T = BATCH, 288, 601
    layers = conv_layers(g, device)
    x = torch.tensor(g.standard_normal((B, 5, H, T)), dtype=torch.float32,
                     device=device)
    n = len(layers)
    s = check_stack("kernel C", x, layers)
    wp, bias, inputs = s["wp"], s["bias"], s["inputs"]
    rel, mean_rel = s["rel"], s["mean_rel"]
    res = {"C": s["max_abs_err"], "C_layers": s["layers"]}

    res["C_ms"] = time_ms(lambda: CS.fused_convstack(x, layers))
    res["C_card_ms"] = graph_ms(lambda: CS.fused_convstack(x, layers))
    res["C_plain_ms"] = time_ms(lambda: CS.fused_convstack_plain(x, layers))
    flops = sum(2 * B * H * T * 8 * w.shape[1] * 49 for w, _ in layers)
    put_bound(res, "C", bound(stack_bytes(B, H, T, 5, n), flops,
                              BF16_FLOPS))
    # each layer alone: NCHW float32 in (5 channels), channels-last bf16
    # between, NCHW float32 out
    for i, (key, nbytes) in enumerate(zip(("C_l1", "C_mid", "C_l3"),
                                          layer_bytes(B, H, T, 5, n))):
        kw = dict(nchw_in=i == 0, nchw_out=torch.float32 if i == n - 1
                  else None)
        res[key + "_card_ms"] = graph_ms(
            lambda i=i, kw=kw: CS.conv7_layer(inputs[i], wp[i], bias[i],
                                              **kw))
        put_bound(res, key, bound(nbytes, 2 * B * H * T * 8
                                  * layers[i][0].shape[1] * 49, BF16_FLOPS))
    # the served 180 s bucket
    x901 = torch.tensor(g.standard_normal((B, 5, H, 901)),
                        dtype=torch.float32, device=device)
    res["C_901_card_ms"] = graph_ms(lambda: CS.fused_convstack(x901, layers))
    put_bound(res, "C_901", bound(
        stack_bytes(B, H, 901, 5, n),
        sum(2 * B * H * 901 * 8 * w.shape[1] * 49 for w, _ in layers),
        BF16_FLOPS))
    del x901
    res.update(conv_library(inputs, wp, bias))
    log(f"[3 kernels] C (3-layer stack, fused_convstack f32 NCHW in and "
        f"out): max|d| per layer {res['C']:.3g}; elements beyond 1 bf16 ulp "
        f"(all within the float32 sum bound) per layer "
        f"{[c['beyond_1ulp'] for c in res['C_layers']]} of {B * H * T * 8}, "
        f"max {[c['max_ulps'] for c in res['C_layers']]} ulps; stack max "
        f"rel {rel:.3g} mean rel {mean_rel:.3g}; {res['C_ms']:.4f} ms eager, "
        f"{res['C_card_ms']:.4f} on the card vs plain "
        f"{res['C_plain_ms']:.4f} ms; {share(res, 'C')}; library cuDNN "
        f"bf16 conv2d x 3, channels padded to 8, benchmark on, best of "
        f"{res['C_library_fmt']}: {res['C_library_ms']:.4f} ms (the old "
        f"yardstick, 5 channels, benchmark off: "
        f"{res['C_library_old_ms']:.4f} ms)")
    log("[3 kernels] C each layer alone on the card: " + "; ".join(
        f"{name} {res[key + '_card_ms']:.4f} ms, bound "
        f"{res[key + '_bound_ms']:.4f} ms ({res[key + '_bound_by']}, "
        f"{res[key + '_bound_ms'] / res[key + '_card_ms']:.1%})"
        for name, key in (("layer 1 (f32 NCHW in)", "C_l1"),
                          ("middle (bf16 channels-last)", "C_mid"),
                          ("layer 3 (f32 NCHW out)", "C_l3")))
        + f"; stack at "
        f"T = 901: {res['C_901_card_ms']:.4f} ms on the card, bound "
        f"{res['C_901_bound_ms']:.4f} ms "
        f"({res['C_901_bound_ms'] / res['C_901_card_ms']:.1%})")
    return res


def conv_library(plain_inputs, wp, bias) -> dict:
    """cuDNN's bf16 conv2d, one call per layer on the layer's circularly
    pre-padded input, with the folded weights and bias (no leaky ReLU).
    The fair yardstick pads the first layer to 8 channels (zero weights)
    so cuDNN may take its tensor-core paths, lets the warm-up choose the
    algorithm (cudnn.benchmark on, restored after) and takes the faster
    of channels-last and NCHW. The old one (unpadded 5 channels,
    channels-last, benchmark off) is kept beside it."""
    n = len(plain_inputs)
    ws = [CS.unpack_weight(wp[i]).contiguous() for i in range(n)]
    bs = [bias[i].to(torch.bfloat16) for i in range(n)]

    def nchw8(i, h):
        h = h.to(torch.bfloat16)
        if i == 0:
            return F.pad(h, (0, 0, 0, 0, 0, 8 - h.shape[1]))
        return h.permute(0, 3, 1, 2)
    padded = [equivariant.circular_pad(nchw8(i, h), 3, 3)
              for i, h in enumerate(plain_inputs)]

    def run(args):
        return lambda: [F.conv2d(xi, w, b) for xi, w, b in args]
    res = {}
    prev = torch.backends.cudnn.benchmark
    try:
        torch.backends.cudnn.benchmark = True
        fmts = {}
        for fmt in (torch.channels_last, torch.contiguous_format):
            args = [(xi.contiguous(memory_format=fmt),
                     w.contiguous(memory_format=fmt), b)
                    for xi, w, b in zip(padded, ws, bs)]
            fmts[str(fmt).split(".")[-1]] = time_ms(run(args))
            del args
    finally:
        torch.backends.cudnn.benchmark = prev
    res["C_library_fmt"] = min(fmts, key=fmts.get)
    res["C_library_ms"] = fmts[res["C_library_fmt"]]
    res["C_library_fmts"] = fmts
    del padded
    old = []
    for i, h in enumerate(plain_inputs):
        xi = h.to(torch.bfloat16) if i == 0 else h.permute(0, 3, 1, 2)
        ci = xi.shape[1]
        old.append((equivariant.circular_pad(xi, 3, 3).contiguous(
            memory_format=torch.channels_last),
            ws[i][:, :ci].contiguous(memory_format=torch.channels_last),
            bs[i]))
    res["C_library_old_ms"] = time_ms(run(old))
    return res


RES_SHAPE = (256, 288, 901)   # resblock.resident: B, H, T at 180 s
RES_MAX_ABS, RES_MEAN_ABS = 1e-4, 1e-6  # tests/test_torch_resconv7_card.py
# a served residual stack against the plain stack, as shares of the plain
# stack's largest and mean magnitude: float32 sums of seven convs in two
# orders
RES_STACK_MAX_REL, RES_STACK_MEAN_REL = 1e-4, 1e-5


@ieee_float32()
def check_res_kernel(device) -> dict:
    """The residual Pitch2Pitch conv kernel (csrc/resconv7.cu) at the
    resblock.resident cell's shapes, each template (stem 5 -> 8, a block's
    8 -> 16 and 16 -> 8 with the skip): against its plain version in IEEE
    float32 (cuDNN, TF32 off for this call), its time beside its float32
    bound (benchmark/yardstick/resstack.conv_bound), the plain version's
    time and one cuDNN F.conv2d (IEEE float32, the conv alone, no
    BatchNorm, skip or leaky-ReLU) on the input circularly pre-padded
    (library_ms: a yardstick the port never calls). A stack summed from
    them: its 7 convs. The served stacks' launches and outputs are held in
    phase 4 (expected_launches, hold_res_stack)."""
    from benchmark.yardstick import resstack
    B, H, T = RES_SHAPE
    g = torch.Generator(device=device).manual_seed(22)
    convs, err = {}, 0.0
    for cin, cout, skip in RS.CONVS:
        x = torch.randn(B, cin, H, T, device=device, generator=g)
        sk = torch.randn(B, cout, H, T, device=device, generator=g) \
            if skip else None
        bnd = 1.0 / (cin * 49) ** 0.5
        c = RS.Conv(
            (torch.rand(cin, 7, 7, cout, device=device, generator=g) * 2 - 1)
            * bnd,
            (torch.rand(cout, device=device, generator=g) * 2 - 1) * bnd,
            1 + 0.2 * torch.randn(cout, device=device, generator=g),
            0.1 * torch.randn(cout, device=device, generator=g))
        d = (RS.resconv7(x, c, sk) - RS.resconv7_plain(x, c, sk)).abs()
        r = {"max_abs_err": float(d.max()), "mean_abs_err": float(d.mean())}
        del d
        if r["max_abs_err"] > RES_MAX_ABS or r["mean_abs_err"] > RES_MEAN_ABS:
            raise AssertionError(f"resconv7 {cin}->{cout}: {r}")
        err = max(err, r["max_abs_err"])
        b = resstack.conv_bound(B, H, T, cin, cout, 7, 7,
                                skip=cout if skip else 0)
        r.update(bound_ms=b["bound_s"] * 1e3, bound_by=b["bound_by"],
                 ms=time_ms(lambda: RS.resconv7(x, c, sk), reps=5),
                 card_ms=graph_ms(lambda: RS.resconv7(x, c, sk), reps=5,
                                  repeat=2),
                 plain_ms=time_ms(lambda: RS.resconv7_plain(x, c, sk),
                                  reps=5))
        xp = equivariant.circular_pad(x, 3, 3)
        w = c.weight.permute(3, 0, 1, 2).contiguous()
        r["library_ms"] = time_ms(lambda: F.conv2d(xp, w, c.bias), reps=5)
        del x, sk, xp
        convs[f"{cin}->{cout}" + (" +skip" if skip else "")] = r
        log(f"[3 kernels] resconv7 {cin}->{cout}{' + skip' if skip else ''} "
            f"at {RES_SHAPE}: max|d| {r['max_abs_err']:.3g} mean "
            f"{r['mean_abs_err']:.3g} against plain (IEEE); {r['ms']:.3f} "
            f"ms eager, {r['card_ms']:.3f} on the card, bound "
            f"{r['bound_ms']:.3f} ms ({r['bound_by']}, "
            f"{r['bound_ms'] / r['card_ms']:.1%}); plain "
            f"{r['plain_ms']:.3f} ms; library cuDNN F.conv2d f32 (IEEE) "
            f"on the pre-padded input {r['library_ms']:.3f} ms")
    torch.cuda.empty_cache()
    # a stack: the stem and three blocks, 7 launches
    per_stack = [convs["5->8"]] + [convs["8->16"], convs["16->8 +skip"]] * 3
    res = {"R": err, "R_convs": convs}
    for key in ("ms", "card_ms", "plain_ms", "library_ms", "bound_ms"):
        res["R_" + key] = sum(r[key] for r in per_stack)
    log(f"[3 kernels] resconv7, a stack (5 -> 8, 3 blocks) summed from its "
        f"7 convs at {RES_SHAPE}: {res['R_card_ms']:.2f} ms on the card "
        f"against its bound {res['R_bound_ms']:.2f} ms "
        f"({res['R_bound_ms'] / res['R_card_ms']:.1%}), plain "
        f"{res['R_plain_ms']:.1f} ms, cuDNN's convs alone "
        f"{res['R_library_ms']:.1f} ms")
    return res


@ieee_float32()
def check_edge_geometries(device) -> None:
    """Small shapes off the main path: odd batches, other sample rates
    and bin counts (12 bins x 8 octaves, n_fft 128: the only_semitones
    front-end), n_fft 8192 (overlapping windows), streams shorter than
    the reflect pad, float input; kernel C at T = H = 3, ragged time tiles
    and H not a multiple of its 8 rows, 1 input channel (the pc2p_mem
    stack) and H = 96 (the stay_sixth and only_semitones stacks), in every
    input and output layout and dtype, and float32 and bf16 stacks.
    Kernel vs plain at the same bars as the main-path checks."""
    g = np.random.default_rng(2)
    cases = [  # (sr, hop, bins/octave, octaves, B, seconds, int16?)
        (8000, 1600, 12, 3, 3, 2.0, True),
        (22050, 4410, 36, 4, 1, 3.0, False),     # n_fft 8192
        (44100, 8820, 36, 7, 2, 5.3, True),
        (22050, 4410, 36, 8, 5, 0.9, True),      # deep streams < pad
        (22050, 4410, 12, 8, 3, 20.0, True),     # only_semitones, n_fft 128
    ]
    for sr, hop, bpo, octaves, B, sec, as_int in cases:
        p = C.CQTParams(sr=sr, hop=hop, bins_per_octave=bpo, octaves=octaves)
        y = g.uniform(-0.6, 0.6, (B, int(sr * sec))).astype(np.float32)
        y = torch.from_numpy(pcm16(y) if as_int else y).to(device)
        for sd in (torch.float32, torch.bfloat16):
            check_cqt(f"cqt_cuda {sd} {p} B={B}",
                      K.cqt_cuda(y, p, stream_dtype=sd),
                      C.cqt(y, p, stream_dtype=sd), sd)
    n_conv = beyond = 0
    geometries = [(1, 5, 3, 3), (3, 8, 7, 65), (2, 5, 288, 5), (1, 8, 9, 130),
                  (3, 5, 11, 129), (2, 1, 288, 601), (2, 5, 96, 601),
                  (2, 8, 20, 601)]
    for B, ci, H, T in geometries:
        layers = conv_layers(g, device, (ci,))
        wp, bias = CS.pack_stack(layers)
        x = torch.tensor(g.standard_normal((B, ci, H, T)),
                         dtype=torch.float32, device=device)
        nhwc = F.pad(x.permute(0, 2, 3, 1), (0, 8 - ci)).to(
            torch.bfloat16).contiguous()
        # (input, nchw_in, nchw_out): every layout and dtype the stack uses
        for xi, nchw_in, nchw_out in [
                (nhwc, False, None), (x, True, None),
                (x.to(torch.bfloat16), True, None),
                (nhwc, False, torch.float32), (nhwc, False, torch.bfloat16),
                (x, True, torch.float32),
                (x.to(torch.bfloat16), True, torch.bfloat16)]:
            got = CS.conv7_layer(xi, wp[0], bias[0], nchw_in, nchw_out)
            ref = CS.conv7_layer_plain(xi, wp[0], bias[0], nchw_in, nchw_out)
            c = check_conv7(f"kernel C at {(B, ci, H, T)}, nchw_in "
                            f"{nchw_in}, nchw_out {nchw_out}", got, ref, xi,
                            wp[0], nchw_in, nchw_out)
            n_conv += 1
            beyond += c["beyond_1ulp"]
        stacked = conv_layers(g, device, (ci, 8, 8))
        for xi in (x, x.to(torch.bfloat16)):
            beyond += check_stack(f"fused_convstack {xi.dtype} at "
                                  f"{(B, ci, H, T)}", xi,
                                  stacked)["beyond_1ulp"]
    # a CUDA tensor the kernel does not take raises; nothing falls back
    refused = 0
    for bad in (lambda: CS.conv7_layer(nhwc.half(), wp[0], bias[0]),
                lambda: CS.conv7_layer(nhwc[:, :, 1:], wp[0], bias[0]),
                lambda: CS.conv7_layer(x.double(), wp[0], bias[0], True),
                lambda: CS.conv7_layer(nhwc, wp[0].float(), bias[0]),
                lambda: CS.fused_convstack(x.half(), stacked)):
        try:
            bad()
        except ValueError:
            refused += 1
    if refused != 5:
        raise AssertionError(f"kernel C took {5 - refused} bad calls")
    log(f"[3 kernels] edge geometries: {len(cases)} CQT cases x 2 stream "
        f"dtypes, {n_conv} conv7 cases ({len(geometries)} geometries x 7 "
        f"layouts) and {2 * len(geometries)} stacks (layer by layer) match "
        f"their plain versions ({beyond} elements beyond 1 bf16 ulp, within "
        "the float32 sum bound); 5 unsupported kernel C calls raised")


# ---------------------------------------------------------------------------
# phase 3o: the served CQT and the default model against the oracles
# ---------------------------------------------------------------------------

ORACLE_MARGIN = 10          # frames: tests/test_cqt.py's 2 s at hop sr/5
KERNEL_CQT_BAR = 1e-3       # of an octave's peak: tests/test_cqt_pallas.py:80
E2E_BARS = {"key": 1e-3, "tonic": 3e-3}     # tests/test_e2e_parity.py:65-66
# the kernel path against the plain path, whole model: key |d| < 3e-2
# (tests/test_convstack_pallas.py:180), tonic 3e-2 of its largest |logit|
# (phase 4's agreement)
E2E_KERNEL_BARS = {"key": 3e-2, "tonic": 3e-2}
# (bins/octave, octaves): lowest octave's (interior, boundary) bars, then
# the other octaves', tests/test_cqt_librosa.py:57-100, at hop 4416
LIBROSA_CASES = {
    (36, 6): ((0.025, 0.035), (0.008, 0.010)),
    (12, 5): ((0.035, 0.045), (0.015, 0.02)),
    (36, 4): ((0.08, 0.30), (0.012, 0.05)),     # early downsample
}
LIBROSA_HOP = 4416
LIBROSA_HOP_8 = 4352        # the multiple of 2**7 nearest 4410
# Where the plain path misses a bar by as much as the kernels (within
# KERNEL_CQT_BAR, or E2E_KERNEL_BARS for the logits), the miss belongs to
# the reference's algorithm (the JAX package's multirate CQT, which the
# plain path is held to on the CPU): at these (case, check, octaves) the
# kernels are held to the plain path's distance plus the kernel bar
# instead of the JAX bar. Recorded from the phase's first run on the H100
# (PERF.md section 6; ROADMAP.md Queue 3, faults in the reference, with
# the numbers). Phase 3's clips carry no partial in
# octaves 0, 6 and 7 (noise only), where the JAX bars were set on a tone
# in every octave; the 12-bin geometry and 120 s boundary frames no JAX
# test ran.
REFERENCE_MISSES = {
    "(a) direct 36x8 hop 4410, phase 3 clips": {
        "interior": (0, 6, 7), "every frame": (0, 1, 4, 7)},
    "(a) direct 12x8 hop 4410, phase 3 clips": {
        "interior": (0, 6, 7), "every frame": (0, 1, 4, 7)},
    "(a) direct 12x8 hop 4410, bar signals": {
        "interior": (5, 6, 7), "every frame": (0, 1, 3, 4, 7)},
    "(b) librosa 36x6 hop 4416, phase 3 clips": {
        "interior": (0,), "boundary": (0,)},
    "(b) librosa 12x5 hop 4416, phase 3 clips": {"boundary": (0, 1)},
    "(b) librosa 12x5 hop 4416, bar signals": {"boundary": (1, 2)},
    "(b) librosa 36x4 hop 4416, phase 3 clips": {
        "interior": (0,), "boundary": (0, 1, 2, 3)},
    "(b) librosa 36x4 hop 4416, bar signals": {
        "interior": (1,), "boundary": (1, 2, 3)},
    "(d) e2e": {"key": (None,), "tonic": (None,)},
}


def octave_dist(got: torch.Tensor, ref: torch.Tensor, bpo: int,
                frames) -> list[float]:
    """Per octave (0 = lowest), max |got - ref| over `frames`, relative to
    ref's peak in that octave over every clip, bin and frame."""
    out = []
    for o in range(ref.shape[1] // bpo):
        r, g = ref[:, o * bpo:(o + 1) * bpo], got[:, o * bpo:(o + 1) * bpo]
        out.append(float((g[..., frames] - r[..., frames]).abs().max()
                         / r.max()))
    return out


def served_magnitudes(y: torch.Tensor, p: C.CQTParams, stream_dtype,
                      kernels: bool) -> tuple:
    """(magnitudes in float64, launches) of the served front-end
    (ops/frontend.compute_cqt: kernels A and B, or the plain path) at
    `stream_dtype`: its float32 log1p output undone."""
    with torch.inference_mode():
        out, launches, _ = counted(lambda: compute_cqt(
            y, p, use_kernels=kernels, conv_dtype=stream_dtype))
    return torch.expm1(out.double()), launches


def oracle_timed(name: str, res: dict, fn):
    """fn() on the card, its wall (ending in a synchronize) kept under
    res["oracle_s"][name]."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    res["oracle_s"][name] = time.perf_counter() - t0
    return out


def held_against(case: str, checks: list, res: dict) -> list:
    """Each (check, octave or None, bar, kernel distance, plain
    distance, kernel bar): the kernels within the bar, or, at a recorded
    reference miss (REFERENCE_MISSES), within the plain path's distance
    plus the kernel bar. Returns the misses left, as text."""
    misses = []
    for check, o, bar, kd, pd, kernel_bar in checks:
        recorded = o in REFERENCE_MISSES.get(case, {}).get(check, ())
        limit = max(bar, pd + kernel_bar) if recorded else bar
        res["held"].append({"case": case, "check": check, "octave": o,
                            "bar": bar, "kernels": kd, "plain": pd,
                            "limit": limit, "reference_miss": recorded})
        if not kd < limit:
            where = "" if o is None else f" octave {o}"
            misses.append(f"{case} {check}{where}: kernels {kd:.4g} "
                          f"(plain {pd:.4g}) against {limit:.4g}"
                          + ("" if recorded else
                             " (plain path misses too)" if pd >= bar else ""))
    return misses


def fmt(d: list) -> str:
    return "[" + " ".join(f"{v:.4f}" for v in d) + "]"


def bar_signals(kind: str, bpo: int, octaves: int, device) -> torch.Tensor:
    """BATCH float32 clips of CLIP_SECONDS at SR of the signal class the
    JAX tests set their bars on, made on the card from seeds: "direct"
    is tests/test_cqt.py::_oracle_case (noise of std 0.1 plus a 0.15
    tone in every octave at 13/36 of it), "librosa" is
    tests/test_cqt_librosa.py::_fixture (a 0.3 tone of random phase on a
    random bin of every octave plus noise of std 0.02). Clip i draws from
    seed i (and its noise from a torch generator of that seed)."""
    t = torch.arange(SR * CLIP_SECONDS, dtype=torch.float64,
                     device=device) / SR
    rows = []
    for i in range(BATCH):
        rng = np.random.default_rng(i)
        gen = torch.Generator(device=device).manual_seed(i)
        noise = torch.randn(t.shape, generator=gen, dtype=torch.float64,
                            device=device)
        if kind == "direct":
            y = 0.1 * noise
            for o in range(octaves):
                y += 0.15 * torch.sin(2 * np.pi * C.C1_HZ
                                      * 2.0 ** (o + 13 / 36) * t)
        else:
            y = 0.02 * noise
            for o in range(octaves):
                k = o * bpo + int(rng.integers(2, bpo - 2))
                y += 0.3 * torch.sin(2 * np.pi * C.C1_HZ * 2 ** (k / bpo) * t
                                     + rng.uniform(0, 6))
        rows.append(y.float())
    return torch.stack(rows)


def oracle_cqt_cases(y16, device, sd, res) -> list:
    """(a) the direct oracle at the served geometry, (b) the librosa
    algorithm at the JAX tests' geometries, (c) the librosa algorithm at
    8 octaves: per octave, the kernels' served CQT and the plain path's
    against the oracle, on phase 3's 16 PCM16 clips and on 16 clips of
    the signal class the JAX tests set their bars on (bar_signals)."""
    misses = []
    hop = C.reference_hop(SR, Config().frames)
    cases = [("a", "direct", bpo, 8, hop, None) for bpo in (36, 12)]
    cases += [("b", "librosa", bpo, octaves, LIBROSA_HOP, bars)
              for (bpo, octaves), bars in LIBROSA_CASES.items()]
    cases += [("c", "librosa", bpo, 8, LIBROSA_HOP_8, None)
              for bpo in (36, 12)]
    for tag, kind, bpo, octaves, hop_c, bars in cases:
        p = C.CQTParams(sr=SR, hop=hop_c, bins_per_octave=bpo,
                        octaves=octaves)
        signals = {"phase 3 clips": y16,
                   "bar signals": bar_signals(kind, bpo, octaves, device)}
        for signal, y in signals.items():
            case = f"({tag}) {kind} {bpo}x{octaves} hop {hop_c}, {signal}"
            yf = y.double() / (32768.0 if y.dtype == torch.int16 else 1.0)
            if kind == "direct":
                ref = oracle_timed(case, res, lambda: oracle_cqt(
                    yf, p, log1p=False))
            else:
                ref = oracle_timed(case, res, lambda: librosa_cqt(
                    yf, SR, hop_c, bpo * octaves, bpo).abs())
            del yf
            got, n = served_magnitudes(y, p, sd, True)
            plain, n_plain = served_magnitudes(y, p, sd, False)
            want = {"cascade_pad": octaves - 1, "octave_response": 1,
                    **{k.name: 0 for k in SK.KERNELS}}
            if n != want or any(n_plain.values()):
                raise AssertionError(f"{case}: launches {n} (want {want}), "
                                     f"plain path {n_plain}")
            res["launches"][case] = n
            T = min(ref.shape[-1], got.shape[-1])
            ref, got, plain = ref[..., :T], got[..., :T], plain[..., :T]
            if kind == "direct":      # tests/test_cqt.py:140-160
                m = ORACLE_MARGIN
                frames = {"interior": slice(m, T - m),
                          "every frame": slice(None)}
            else:                     # tests/test_cqt_librosa.py::_compare
                frames = {"interior": slice(1, T - 1), "boundary": [0, T - 1]}
            d = {k: (octave_dist(got, ref, bpo, fr),
                     octave_dist(plain, ref, bpo, fr))
                 for k, fr in frames.items()}
            checks = []
            for i, k in enumerate(frames):
                for o in range(octaves):
                    if kind == "direct":
                        bar = (0.015 if k == "interior" else
                               0.01 if o == octaves - 1 else 0.8)
                    elif bars:
                        bar = (bars[0] if o == 0 else bars[1])[i]
                    else:
                        bar = d[k][1][o] + KERNEL_CQT_BAR
                    checks.append((k, o, bar, d[k][0][o], d[k][1][o],
                                   KERNEL_CQT_BAR))
            misses += held_against(case, checks, res)
            for k, (kd, pd) in d.items():
                log(f"[3o oracle] {case} (16 x {CLIP_SECONDS} s), {k}: "
                    f"kernels {fmt(kd)}, plain {fmt(pd)} of each octave's "
                    f"peak, octave 0 lowest (oracle "
                    f"{res['oracle_s'][case]:.2f} s; launches A "
                    f"{n['cascade_pad']} B {n['octave_response']}"
                    + ("" if kind == "direct" or bars else
                       f"; held to the plain path + {KERNEL_CQT_BAR:g}")
                    + ")")
            del ref, got, plain
    return misses


def oracle_e2e(waves16, device, res) -> list:
    """(d) wav -> logits: the default model served through kernels A, B
    and C (predict_waveforms, 16 clips in the 180 s bucket) and through
    the plain path, each against the reference pipeline: the direct
    oracle's log1p CQT of the same bucket-padded batch (float64) into a
    float64 copy of the port's model with the plain stacks, same
    weights."""
    cfg = Config(fused_convstack=True)
    weights = seeded_weights(cfg)
    est = KeyEstimator(cfg, weights, device=device)
    plain = KeyEstimator(cfg.replace(use_pallas_cqt="off",
                                     fused_convstack=False), weights,
                         device=device)
    est.predict_waveforms(waves16, SR)        # warm-up
    preds, n, _, _, _ = served(
        est, lambda: est.predict_waveforms(waves16, SR, return_raw=True))
    want = expected_launches(est)
    if n != want:
        raise AssertionError(f"(d): launches {n}, its gate says {want}")
    res["launches"]["(d) e2e served"] = n
    ref_plain = plain.predict_waveforms(waves16, SR, return_raw=True)
    cfg64 = cfg.replace(dtype=torch.float64, use_pallas_cqt="off",
                        fused_convstack=False)
    model = build_model(cfg64)
    load_state_dict(model, weights)
    model = model.to(device=device, dtype=torch.float64).eval()
    batch, seq, hop = est.make_batch(waves16, SR)
    p = C.CQTParams(sr=SR, hop=hop, bins_per_octave=cfg.bins_per_octave,
                    octaves=cfg.octaves)

    def reference():
        with torch.inference_mode():
            mel = oracle_cqt(batch.double() / 32768.0, p)
            return [o.double().cpu().numpy()
                    for o in model(mel[..., None], seq)]
    ref = oracle_timed("(d) oracle CQT + float64 model", res, reference)
    misses = []
    for i, head in enumerate(("key", "tonic")):
        field = "key_probs" if head == "key" else "tonic_logits"
        kd = np.array([np.abs(getattr(q, field) - r).max()
                       for q, r in zip(preds, ref[i])])
        pd = np.array([np.abs(getattr(q, field) - r).max()
                       for q, r in zip(ref_plain, ref[i])])
        scale = 1.0 if head == "key" else float(np.abs(ref[i]).max())
        res["e2e"][head] = {"kernels": kd.tolist(), "plain": pd.tolist()}
        misses += held_against("(d) e2e", [(
            head, None, E2E_BARS[head], float(kd.max()), float(pd.max()),
            E2E_KERNEL_BARS[head] * scale)], res)
        log(f"[3o oracle] (d) e2e {head} max |d| per clip against the "
            f"reference pipeline: kernels (A {n['cascade_pad']} B "
            f"{n['octave_response']} C {n['conv7_layer']}) "
            + " ".join(f"{v:.2e}" for v in kd) + "; plain float32 "
            + " ".join(f"{v:.2e}" for v in pd) + f" (bar {E2E_BARS[head]:g})")
    ref_keys = [key_name(k, t)["key"] for k, t in zip(*ref[:2])]
    same = {name: sum(q.key == k for q, k in zip(preds, keys)) for name, keys
            in (("reference", ref_keys), ("plain", [q.key for q in
                                                    ref_plain]))}
    res["e2e"]["same_keys"] = same
    log(f"[3o oracle] (d) key calls of the kernel path equal the reference "
        f"pipeline's on {same['reference']}/{len(preds)} clips, the plain "
        f"path's on {same['plain']}/{len(preds)} (e.g. {preds[0].key!r} / "
        f"{ref_keys[0]!r}); reference pipeline "
        f"{res['oracle_s']['(d) oracle CQT + float64 model']:.2f} s")
    return misses


def run_oracle(waves, device) -> dict:
    """Phase 3o: the kernels' served CQT (kernels A and B, A octaves - 1
    and B 1 launches a call) and the default model through A, B and C
    (7 / 1 / 3) held against the float64 oracles (ops/cqt_oracle.py,
    ops/librosa_ref.py) computed on the card, at 16 x 120 s: phase 3's
    PCM16 clips and 16 clips of the JAX tests' signal class. The JAX
    bars of tests/test_cqt.py:140-160, tests/test_cqt_librosa.py:57-100
    and tests/test_e2e_parity.py:65-66 hold the kernels, except at the
    misses REFERENCE_MISSES records, where the plain path misses as
    much: there the kernels are held to the plain path's distance plus
    the kernel bar (1e-3 of the octave's peak; 3e-2 for the logits).
    (c)'s 8-octave librosa cases have no JAX bar and take that rule
    everywhere. Every distance is printed beside the plain path's, and
    every miss is listed before the phase fails."""
    if device.type != "cuda":
        raise RuntimeError(f"phase 3o runs on the card, got {device}")
    t0 = time.perf_counter()
    waves16 = [pcm16(w) for w in waves]
    y16 = torch.from_numpy(np.stack(waves16)).to(device)
    sd = torch_dtype(Config().cqt_conv_dtype)
    res = {"launches": {}, "oracle_s": {}, "held": [], "e2e": {}}
    misses = oracle_cqt_cases(y16, device, sd, res)
    del y16
    misses += oracle_e2e(waves16, device, res)
    torch.cuda.empty_cache()
    res["wall_s"] = time.perf_counter() - t0
    log(f"[3o oracle] oracles on the card: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in res["oracle_s"].items())
        + f"; phase wall {res['wall_s']:.1f} s ({card_line()})")
    if misses:
        raise AssertionError("phase 3o: " + "; ".join(misses))
    return res


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------

@functools.cache
def seeded_weights(cfg: Config) -> dict:
    """The weights of the model cfg describes (build_model: PitchClassNet,
    or the multi-scale ensemble) from torch.Generator seed 0, BatchNorm
    affines drawn from it too (so the fold is exercised), then every
    BatchNorm's statistics measured on four 10 s clips through the plain
    float32 path on the CPU, each tower's on its own CQT (36 or 12
    bins/octave). With statistics drawn at random each layer shrinks the
    signal, so the key outputs hang on the biases and barely differ
    between clips, and no end-to-end comparison could see an error
    upstream; measured, each layer's output has unit scale per channel."""
    g = torch.Generator().manual_seed(0)
    cfg32 = cfg.replace(dtype="float32", use_pallas_cqt="off",
                        fused_convstack=False)
    model = build_model(cfg32, generator=g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.weight.copy_(1.0 + 0.2 * torch.randn(m.weight.shape,
                                                       generator=g))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
    est = KeyEstimator(cfg32, model.state_dict(), device="cpu")
    batch, seq, hop = est.make_batch([pcm16(w[:10 * SR]) for w in clips(4)],
                                     SR)
    with torch.no_grad():
        mels = est.features(batch, SR, hop)
        for m in est.model.modules():
            if isinstance(m, BatchNorm):
                m.momentum = 1.0      # running statistics := this batch's
                m.train()
        est.model(*mels, seq)
    return est.model.state_dict()


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


# every variant of the model the port serves (the JAX package's test
# matrix, tests/test_torch_port.py:210-222), at the default Config's full
# widths, and the default model in bf16
VARIANTS = {
    "default": {},
    "resblock": dict(resblock=True),
    "denseblock": dict(denseblock=True),
    "p2pc_conv": dict(p2pc_conv=True),
    "pc2p_mem": dict(pc2p_mem=True),
    "stay_sixth": dict(stay_sixth=True),
    "only_semitones": dict(only_semitones=True),
    "max_pool": dict(max_pool=True),
    "three_layers": dict(num_layers=3, conv_layers=1),
    "resblock_pc2p_mem": dict(resblock=True, pc2p_mem=True),
    "dense_p2pc_conv": dict(denseblock=True, p2pc_conv=True),
    "bf16": dict(dtype="bfloat16"),
}
# the two-tower ensemble: two CQTs (36 and 12 bins/octave), kernel C on
# model1's stack at H = 288 and model2's at H = 96
MULTI_SCALE = {
    "multi_scale": dict(multi_scale=True),
    "multi_scale_linear_reg_genre": dict(multi_scale=True,
                                         linear_reg_multi=True, genre=True),
}
COUNTERS = (K.cascade_pad, K.octave_response,
            *(k.counter for k in SK.KERNELS))


def kernel_stacks(model: torch.nn.Module, name: str | None = None) -> list:
    """The ConvStacks of `model`, in every tower, with a hand kernel
    (ConvStack.kernel, of that name if given) and fused_serving on."""
    return [m for m in model.modules() if isinstance(m, ConvStack)
            and m.kernel is not None and m.fused_serving
            and name in (None, m.kernel.name)]


def stack_launches(model: torch.nn.Module, dtype) -> dict:
    """Launches of each stack kernel one eval forward of `model` in
    `dtype` makes: each stack's kernel's own count (C once per layer,
    resconv7 once per conv) where the kernel takes the dtype."""
    return {k.name: sum(k.launches(m) for m in kernel_stacks(model, k.name)
                        if torch_dtype(dtype) in k.dtypes)
            for k in SK.KERNELS}


def expected_launches(est: KeyEstimator) -> dict:
    """Launches one served batch must make, from its config: for each CQT
    the model consumes (feature_bins: one, or two for the multi-scale
    ensemble) kernel A once per octave step and B once; each stack
    kernel as stack_launches counts it."""
    n_cqt = len(feature_bins(est.cfg))
    return {"cascade_pad": n_cqt * (est.cfg.octaves - 1),
            "octave_response": n_cqt,
            **stack_launches(est.model, est.cfg.dtype)}


def counted(fn):
    """fn() with every kernel count set to 0 just before and read just
    after; returns (result, launches, wall seconds). The heap is
    collected first: where the interpreter's next full collection falls
    depends on everything the process allocated before, and one that
    lands inside the timed call adds its cost to that call's wall."""
    gc.collect()
    for c in COUNTERS:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, {c.__name__: c.launches for c in COUNTERS}, wall


def served(est: KeyEstimator, fn):
    """counted(fn), recording what the served batch gave the kernels:
    each est.features call's (batch, sr, hop) and log-CQTs (kernels A and
    B; two for the multi-scale ensemble; one call per shard of the mesh),
    and the input of every ConvStack with a hand kernel (kernel_stacks),
    in every tower and every replica.
    Returns (result, launches, wall seconds, features, stacks)."""
    feats, stacks = [], []
    nets = [*est.replicas, *est.local_replicas]
    hooks = [m.register_forward_pre_hook(
        lambda m, args: stacks.append((m, args[0])))
        for net in nets for m in kernel_stacks(net)]
    features = est.features

    def recording(batch, sr, hop):
        out = features(batch, sr, hop)
        feats.append((batch, sr, hop, out))
        return out
    est.features = recording
    try:
        out, launches, wall = counted(fn)
    finally:
        del est.features
        for h in hooks:
            h.remove()
    return out, launches, wall, feats, stacks


@ieee_float32()
def hold_served(name: str, est: KeyEstimator, feats, stacks) -> dict:
    """The served batch's kernel work again on its own card tensors,
    against the plain versions: each of its log-CQTs (one per
    feature_bins entry) against the plain cqt at its own bins/octave at
    check_cqt's bars, every stack kernel C took, in every tower, layer
    by layer at check_conv7's bars (check_stack), and every stack resconv7
    took, whole, against residual_stack_plain (hold_res_stack). The plain
    versions in IEEE float32, as the served path computes float32."""
    cfg = est.cfg
    sd = torch_dtype(cfg.cqt_conv_dtype)
    res = {"cqt_d": 0.0, "cqt_bins": [], "stacks": [], "c_d": 0.0,
           "beyond_1ulp": 0, "stack_rel": 0.0, "resconv7_stacks": [],
           "r_rel": 0.0}
    if not feats:
        raise AssertionError(f"{name}: the served batch ran no CQT")
    with torch.inference_mode():
        for batch, sr, hop, mels in feats:
            if len(mels) != len(feature_bins(cfg)):
                raise AssertionError(f"{name}: {len(mels)} CQTs served")
            for bpo, got in zip(feature_bins(cfg), mels):
                p = C.CQTParams(sr=sr, hop=hop, bins_per_octave=bpo,
                                octaves=cfg.octaves)
                res["cqt_d"] = max(res["cqt_d"], check_cqt(
                    f"{name}: served CQT {p}", got[..., 0],
                    C.cqt(batch, p, stream_dtype=sd), sd))
                res["cqt_bins"].append(bpo)
            res["cqt_batch"] = tuple(batch.shape)
        for m, x in stacks:
            if not m.runs_kernel(x):
                raise AssertionError(f"{name}: {m.kernel.name}'s gate "
                                     f"refused a stack at {tuple(x.shape)} "
                                     f"{x.dtype}")
            if m.kernel.name == "resconv7":
                res["r_rel"] = max(res["r_rel"], hold_res_stack(name, m, x))
                res["resconv7_stacks"].append(f"{tuple(x.shape)}")
                continue
            s = check_stack(f"{name}: served stack {tuple(x.shape)} "
                            f"{x.dtype}", x,
                            m.kernel.operands(m.conv_pairs()))
            res["stacks"].append(f"{len(m.cins)} x {tuple(x.shape)} "
                                 f"{str(x.dtype).split('.')[-1]}")
            res["c_d"] = max(res["c_d"], s["max_abs_err"])
            res["beyond_1ulp"] += s["beyond_1ulp"]
            res["stack_rel"] = max(res["stack_rel"], s["rel"])
    return res


def hold_res_stack(name: str, m: ConvStack, x: torch.Tensor) -> float:
    """One served resconv7 stack again on its own input, 7 launches,
    against the plain stack: max |d| within RES_STACK_MAX_REL of the
    plain stack's largest magnitude, mean |d| within RES_STACK_MEAN_REL of
    its mean magnitude. Returns the max |d| over the largest."""
    convs = m.kernel.operands(m.conv_pairs())
    n = RS.resconv7.launches
    got = RS.residual_stack(x, convs)
    if RS.resconv7.launches != n + m.kernel.launches(m):
        raise AssertionError(f"{name}: a resconv7 stack launched "
                             f"{RS.resconv7.launches - n} times")
    ref = RS.residual_stack_plain(x, convs)
    d = (got - ref).abs()
    rel = float(d.max() / ref.abs().max())
    mean_rel = float(d.mean() / ref.abs().mean())
    if not (rel <= RES_STACK_MAX_REL and mean_rel <= RES_STACK_MEAN_REL):
        raise AssertionError(f"{name}: served resconv7 stack "
                             f"{tuple(x.shape)} max rel {rel:.3g}, mean rel "
                             f"{mean_rel:.3g}")
    return rel


def agreement(name: str, preds, ref, shape) -> dict:
    """Served outputs against the plain path's: finite, keys of `shape`;
    key probabilities within 3e-2, tonic logits within 3e-2 of their
    largest magnitude (tests/test_torch_gate.py's bars). And how far the
    key probabilities spread: their range over every output, and the
    largest range of one output across clips, which must reach 0.05, or
    the keys do not answer to the audio and no agreement would mean
    anything."""
    key = np.stack([q.key_probs for q in preds])
    tonic = np.stack([q.tonic_logits for q in preds])
    key_ref = np.stack([q.key_probs for q in ref])
    tonic_ref = np.stack([q.tonic_logits for q in ref])
    if key.shape != shape or tonic.shape != shape \
            or not np.isfinite(key).all() or not np.isfinite(tonic).all():
        raise AssertionError(f"{name}: bad outputs {key.shape} "
                             f"{tonic.shape}, want {shape}")
    res = {"key_d": float(np.abs(key - key_ref).max()),
           "tonic_rel_d": float(np.abs(tonic - tonic_ref).max()
                                / np.abs(tonic_ref).max()),
           "key_min": float(key.min()), "key_max": float(key.max()),
           "key_spread": float((key.max(0) - key.min(0)).max())}
    if res["key_d"] >= 3e-2 or res["tonic_rel_d"] >= 3e-2 \
            or res["key_spread"] < 0.05:
        raise AssertionError(f"{name}: against the plain path {res}")
    return res


def agreement_text(a: dict) -> str:
    return (f"key |d| vs plain {a['key_d']:.3g}, tonic |d| "
            f"{a['tonic_rel_d']:.3g} of its peak; keys in "
            f"[{a['key_min']:.3f}, {a['key_max']:.3f}], spread across clips "
            f"{a['key_spread']:.3f}")


def held_text(name: str, h: dict) -> str:
    bins = "/".join(str(b) for b in h["cqt_bins"])
    return (f"[4 serve] {name}, the served batch's own tensors: CQT "
            f"{h['cqt_batch']} at {bins} bins/octave vs plain max|d| "
            f"{h['cqt_d']:.3g}; kernel C "
            f"stacks [{', '.join(h['stacks'])}] layer by layer max|d| "
            f"{h['c_d']:.3g}, {h['beyond_1ulp']} elements beyond 1 bf16 ulp "
            f"(within the float32 sum bound), stack max rel "
            f"{h['stack_rel']:.3g}"
            + (f"; resconv7 stacks [{', '.join(h['resconv7_stacks'])}] "
               f"whole, max |d| {h['r_rel']:.3g} of the plain stack's "
               f"largest" if h["resconv7_stacks"] else ""))


def serve_variants(paths, device) -> dict:
    """Every variant and the multi-scale ensemble served on the card with
    the default Config's widths (fused_convstack on, seeded weights): its
    launches (A 7 and B 1 per CQT, C as its gate takes in every tower:
    expected_launches); the served batch's CQTs and kernel C stacks against
    their plain versions on the batch's own tensors (hold_served); key and
    tonic against the plain path on the card (agreement) and key against
    the plain path on the CPU (two 10 s clips); its wall beside the plain
    path's and kernel C's share of its model stage. For the default also
    the stage split and the model stage's largest rows."""
    res = {}
    audio_min = len(paths) * CLIP_SECONDS / 60.0
    for name, kw in (VARIANTS | MULTI_SCALE).items():
        cfg = Config(fused_convstack=True, **kw)
        weights = seeded_weights(cfg)
        est = KeyEstimator(cfg, weights, device=device)
        plain = KeyEstimator(cfg.replace(use_pallas_cqt="off",
                                         fused_convstack=False),
                             weights, device=device)
        est.predict_files(paths)      # warm-up: allocator, cuDNN, constants
        plain.predict_files(paths)
        preds, launches, wall, feats, stacks = served(
            est, lambda: est.predict_files(paths, return_raw=True))
        want = expected_launches(est)
        if launches != want:
            raise AssertionError(f"variant {name}: launches {launches}, "
                                 f"its gate says {want}")
        t0 = time.perf_counter()
        ref = plain.predict_files(paths, return_raw=True)
        torch.cuda.synchronize()
        wall_plain = time.perf_counter() - t0
        agree = agreement(f"variant {name}", preds, ref, (len(paths), 12))
        held = hold_served(f"variant {name}", est, feats, stacks)
        del feats, stacks
        dcpu = cpu_cross_check(est, weights, cfg)
        split = model_split(f"variant {name}", est, paths,
                            want["conv7_layer"] > 0)
        res[name] = {"launches": launches, **agree, "cpu_key_d": dcpu,
                     "wall_ms": wall * 1e3, "plain_wall_ms": wall_plain * 1e3,
                     "split": split, "held": held}
        log(f"[4 serve] variant {name}: launches A {launches['cascade_pad']}"
            f" B {launches['octave_response']} C {launches['conv7_layer']} "
            f"resconv7 {launches['resconv7']}; "
            f"{agreement_text(agree)}; key |d| vs CPU {dcpu:.3g}; e.g. "
            f"{preds[0].key!r} / plain {ref[0].key!r}; wall "
            f"{wall * 1e3:.1f} ms = {audio_min / wall:.1f} audio-min/s "
            f"(plain path {wall_plain * 1e3:.1f} ms); model stage "
            f"{split['total_ms']:.3f} ms device, kernel C "
            f"{split['conv7_ms']:.3f} ms "
            f"({split['conv7_ms'] / split['total_ms']:.1%}; "
            f"{split['pads_lost']} pad rows lost), largest "
            + "; ".join(f"{k[:50]} {v:.3f} ms" for k, v in split["top"][:2])
            + towers_text(split) + f" ({card_line()})")
        log(held_text(f"variant {name}", held))
        if name == "default":
            stages = stage_ms(est, paths)
            log("[4 serve] default stages (host clock, each ending in a "
                "synchronize): " + ", ".join(f"{k} {v:.1f} ms"
                                             for k, v in stages.items()))
            log(f"[4 serve] default model stage on the card (torch.profiler,"
                f" device rows only, cuDNN float32 convolutions "
                f"{split['conv_fp32']}): "
                f"{split['total_ms']:.3f} ms in {split['kernels']} kernels "
                f"({split['launch_records']} launch calls on the host, "
                f"{split['unrecorded']} without a device row; the trace "
                f"lost {split['pads_lost']} of its {PAD_LAUNCHES} pad "
                "rows); "
                f"kernel C {split['conv7_ms']:.3f} ms "
                f"({split['conv7_ms'] / split['total_ms']:.1%}, "
                f"{split['conv7_launches']} launches), the rest "
                f"{split['total_ms'] - split['conv7_ms']:.3f} ms; largest: "
                + "; ".join(f"{k[:60]} {v:.3f} ms" for k, v in split['top']))
        del est, plain
        torch.cuda.empty_cache()
    return res


def serve_local(paths, device, name: str = "default", **kw) -> dict:
    """A model (the default, or Config(**kw)) through predict_files_local:
    launches as expected_launches says (A 7, B 1, C 3 for the default; A
    14, B 2, C 6 for the multi-scale ensemble); one window per frame step,
    (601 - frames * loc_window_size + 1) for a 120 s clip, the first over
    [0, loc_window_size) s; the served batch's kernels held as in
    serve_variants; every window's outputs against the plain local path's
    (agreement)."""
    cfg = Config(fused_convstack=True, **kw)
    weights = seeded_weights(cfg)
    est = KeyEstimator(cfg, weights, device=device)
    plain = KeyEstimator(cfg.replace(use_pallas_cqt="off",
                                     fused_convstack=False),
                         weights, device=device)
    est.predict_files_local(paths)    # warm-up
    preds, launches, wall, feats, stacks = served(
        est, lambda: est.predict_files_local(paths, return_raw=True))
    if launches != expected_launches(est) or not launches["conv7_layer"]:
        raise AssertionError(f"local serve {name} launches {launches}")
    ref = plain.predict_files_local(paths, return_raw=True)
    frames = 1 + CLIP_SECONDS * cfg.frames
    n_win = frames - cfg.frames * cfg.loc_window_size + 1
    for q in preds:
        w0 = q.windows[0]
        if len(q.windows) != n_win \
                or (w0.start, w0.end) != (0.0, float(cfg.loc_window_size)):
            raise AssertionError(f"local serve: {len(q.windows)} windows, "
                                 f"first {w0}, want {n_win}")
    agree = agreement(f"local {name}", preds, ref, (len(paths), n_win, 12))
    held = hold_served(f"local {name}", est, feats, stacks)
    del feats, stacks
    audio_min = len(paths) * CLIP_SECONDS / 60.0
    split = model_split(f"local {name}", est, paths, local=True)
    log(f"[4 serve] local mode {name} (predict_files_local): {n_win} windows"
        f" per clip, first [{w0.start}, {w0.end}) s; launches A "
        f"{launches['cascade_pad']} B {launches['octave_response']} C "
        f"{launches['conv7_layer']}; over {len(preds) * n_win} windows "
        f"{agreement_text(agree)}; wall {wall * 1e3:.1f} ms = "
        f"{audio_min / wall:.1f} audio-min/s; model stage "
        f"{split['total_ms']:.3f} ms device, kernel C "
        f"{split['conv7_ms']:.3f} ms "
        f"({split['conv7_ms'] / split['total_ms']:.1%}; "
        f"{split['pads_lost']} pad rows lost)"
        + towers_text(split) + f" ({card_line()})")
    log(held_text(f"local mode {name}", held))
    return {"launches": launches, "windows": n_win, **agree,
            "wall_ms": wall * 1e3, "model_ms": split["total_ms"],
            "conv7_ms": split["conv7_ms"], "held": held}


def write_encoded(path: str, y: np.ndarray, sr: int, enc: str) -> str:
    """Mono WAV of y in one encoding: "pcm16" (audio_io.write_wav),
    "f32" (IEEE float) or "s24" (24-bit PCM)."""
    if enc == "pcm16":
        audio_io.write_wav(path, y, sr)
        return path
    if enc == "f32":
        fmt, bits, data = 3, 32, np.asarray(y, "<f4").tobytes()
    elif enc == "s24":
        v = np.round(np.clip(y, -1, 1) * (2 ** 23 - 1)).astype("<i4")
        fmt, bits = 1, 24
        data = v.view("u1").reshape(-1, 4)[:, :3].tobytes()
    else:
        raise ValueError(f"encoding {enc!r}")
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, fmt, 1, sr,
                                      sr * bits // 8, bits // 8, bits))
        f.write(b"data" + struct.pack("<I", len(data)) + data)
    return path


ENCODINGS = ("pcm16", "f32", "s24")


def serve_mixed(waves, td: str, device) -> dict:
    """One default-variant batch of PCM16, float32 and 24-bit WAVs (16 x
    120 s): decode gives int16 and float32 waveforms, so the batch goes
    to kernels A, B and C as float32 (pack_batch); launches A 7, B 1,
    C 3; the served batch held as in serve_variants (hold_served), its
    outputs against the plain path's (agreement)."""
    paths = [write_encoded(os.path.join(td, f"mixed_{i}.wav"), w, SR,
                           ENCODINGS[i % 3]) for i, w in enumerate(waves)]
    cfg = Config(fused_convstack=True)
    weights = seeded_weights(cfg)
    est = KeyEstimator(cfg, weights, device=device)
    plain = KeyEstimator(cfg.replace(use_pallas_cqt="off",
                                     fused_convstack=False),
                         weights, device=device)
    est.predict_files(paths)      # warm-up
    plain.predict_files(paths)
    preds, launches, wall, feats, stacks = served(
        est, lambda: est.predict_files(paths, return_raw=True))
    if launches != expected_launches(est) or launches["conv7_layer"] != 3:
        raise AssertionError(f"mixed-encoding serve launches {launches}")
    if [b.dtype for b, *_ in feats] != [torch.float32]:
        raise AssertionError("mixed-encoding serve: batches "
                             f"{[b.dtype for b, *_ in feats]}, want one "
                             "float32 batch")
    t0 = time.perf_counter()
    ref = plain.predict_files(paths, return_raw=True)
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    agree = agreement("mixed encodings", preds, ref, (len(paths), 12))
    held = hold_served("mixed encodings", est, feats, stacks)
    del feats, stacks
    audio_min = len(paths) * CLIP_SECONDS / 60.0
    log(f"[4 serve] mixed encodings (PCM16, float32, 24-bit WAV; one "
        f"float32 batch): launches A {launches['cascade_pad']} B "
        f"{launches['octave_response']} C {launches['conv7_layer']}; "
        f"{agreement_text(agree)}; wall {wall * 1e3:.1f} ms = "
        f"{audio_min / wall:.1f} audio-min/s (plain path "
        f"{wall_plain * 1e3:.1f} ms) ({card_line()})")
    log(held_text("mixed encodings", held))
    return {"launches": launches, **agree, "wall_ms": wall * 1e3,
            "plain_wall_ms": wall_plain * 1e3, "held": held}


# ---------------------------------------------------------------------------
# phase 4p: float32 with TF32 allowed (torch's defaults) against IEEE
# ---------------------------------------------------------------------------

KEY_RTOL, KEY_ATOL = 1e-4, 1e-5       # model logits, f32 (key)
TONIC_TOL = 1e-4                      # tonic, rtol and atol
WAV_KEY, WAV_TONIC = 1e-3, 3e-3       # wav -> logits


def float32_bars(got, ref) -> dict:
    """(key, tonic) against a reference: |d| of each, the largest ratio
    of |d| to the float32 logit bars (key rtol 1e-4 / atol 1e-5, tonic
    1e-4 / 1e-4; above 1 is outside), and the ratio to the wav -> logits
    bars (key 1e-3, tonic 3e-3)."""
    (k, t), (kr, tr) = [[torch.as_tensor(np.asarray(a)).double()
                         for a in x[:2]] for x in (got, ref)]
    dk, dt = (k - kr).abs(), (t - tr).abs()
    return {"key_d": float(dk.max()), "tonic_d": float(dt.max()),
            "logit_ratio": max(
                float((dk / (KEY_ATOL + KEY_RTOL * kr.abs())).max()),
                float((dt / (TONIC_TOL + TONIC_TOL * tr.abs())).max())),
            "wav_ratio": max(float(dk.max()) / WAV_KEY,
                             float(dt.max()) / WAV_TONIC)}


def bars_text(b: dict) -> str:
    return (f"key |d| {b['key_d']:.3g}, tonic |d| {b['tonic_d']:.3g}; "
            f"{b['logit_ratio']:.3g} x the float32 logit bars (rtol 1e-4 / "
            f"atol 1e-5), {b['wav_ratio']:.3g} x the wav -> logits bars "
            f"(key 1e-3, tonic 3e-3)")


@contextlib.contextmanager
def tf32_everywhere():
    """TF32 for cuBLAS matmuls too (torch's defaults leave them IEEE), as
    a user's `torch.backends.cuda.matmul.allow_tf32 = True` asks; the
    process's settings restored after."""
    matmul = torch.backends.cuda.matmul
    prev = matmul.allow_tf32, matmul.fp32_precision
    matmul.allow_tf32 = True
    try:
        yield
    finally:
        # the legacy flag, then the per-operator setting it overwrote
        matmul.allow_tf32, matmul.fp32_precision = prev


def both_ways(fn, reps: int = 10, ways=("tf32", "ieee")) -> dict:
    """fn() under this process's settings (torch's defaults: cuDNN runs
    float32 convolutions as TF32, cuBLAS matmuls in IEEE float32), under
    ieee_float32 and, if asked, under tf32_everywhere, with the median
    CUDA-event ms of each."""
    ctx = {"tf32": contextlib.nullcontext, "ieee": ieee_float32,
           "tf32_everywhere": tf32_everywhere}
    out = {}
    for way in ways:
        with ctx[way]():
            out[way] = fn()
            out[way + "_ms"] = time_ms(fn, reps=reps, warmup=2)
    return out


def forward_both_ways(name: str, cfg: Config, waves, device) -> dict:
    """The model of cfg (seeded weights) called directly on the served
    batch's CQT (kernels A and B, which no flag governs), TF32 allowed and
    IEEE: outputs against each other at the float32 bars, and the model
    stage's ms both ways. Then KeyEstimator.outputs on the same clips with
    TF32 allowed globally, which must give the IEEE numbers."""
    est = KeyEstimator(cfg, seeded_weights(cfg), device=device)
    with torch.inference_mode():
        batch, seq, hop = est.make_batch(waves, SR)
        mels = est.features(batch, SR, hop)
        r = both_ways(lambda: [o.float().cpu() for o in est.model(*mels,
                                                                  seq)])
    r["bars"] = float32_bars(r["tf32"], r["ieee"])
    entry = est.outputs(waves, SR)[0]
    r["entry"] = float32_bars(entry, r["ieee"])
    if r["entry"]["key_d"] > 1e-6 or r["entry"]["tonic_d"] > 1e-6:
        raise AssertionError(f"{name}: KeyEstimator.outputs with TF32 "
                             f"allowed is not the IEEE forward: "
                             f"{r['entry']}")
    log(f"[4p precision] {name} forward on {len(waves)} x "
        f"{CLIP_SECONDS} s (T {mels[0].shape[2]}), TF32 allowed vs IEEE "
        f"float32: {bars_text(r['bars'])}; model stage {r['tf32_ms']:.3f} "
        f"ms TF32 allowed, {r['ieee_ms']:.3f} ms IEEE; "
        f"KeyEstimator.outputs under TF32 allowed vs the IEEE forward: "
        f"key |d| {r['entry']['key_d']:.3g}, tonic |d| "
        f"{r['entry']['tonic_d']:.3g} (bar 1e-6) ({card_line()})")
    return r


def grad_step(cfg: Config, batch: dict, device) -> dict:
    """One train step's loss and averaged gradients computed directly (no
    entry point, so the caller's precision settings hold): acc_grad
    micro-batches through trainer.forward, compute_loss and backward
    from create_train_state(cfg, 0) (drop 0), no optimizer update.
    Returns loss, gradients on the host and the wall (ms)."""
    st = T.create_train_state(cfg, 0, device)
    st.model.train()
    acc = batch["mel"].shape[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for i in range(acc):
        micro = {k: v[i] for k, v in batch.items()}
        loss, _ = compute_loss(cfg, T.forward(st.model, cfg, micro), micro)
        loss.backward()
        losses.append(loss.detach())
    loss = float(torch.stack(losses).mean())
    wall = (time.perf_counter() - t0) * 1e3
    return {"loss": loss, "ms": wall,
            "grads": {k: p.grad.detach().cpu() / acc for k, p in
                      st.model.named_parameters()}}


def step_text(d: dict) -> str:
    return (f"loss rel {d['loss_rel']:.3g}, gradients at "
            f"{d['grad']['ratio']:.3g} of phase 6's bar (worst "
            f"{d['grad']['name']} |d| {d['grad']['d']:.3g})")


def train_both_ways(cfg: Config, batch: dict, val, device) -> dict:
    """One train step of 64 songs (phase 6's first batch) computed
    directly, TF32 allowed and IEEE, on cuDNN's deterministic algorithms
    like the entry point below (each twice: the second is timed, and
    the two IEEE runs give the card's run-to-run spread): loss and
    gradients against IEEE at phase 6's bars. Then the entry points with
    TF32 allowed globally: train_step's loss and gradients must lie within
    twice the IEEE spread (or 1e-3 of the bar), and eval_step's outputs
    on the first validation batch must equal the IEEE eval forward's."""
    tb = T.to_device(batch, device)
    # cuDNN's default backward-filter algorithms add with atomics, so two
    # IEEE steps differ by as much as 0.9e-3 of the bar, the entry point
    # by up to 1.4e-3: the twice-the-spread bar failed on that noise
    # alone. Deterministic algorithms, alike on every side, leave the
    # precision as the one difference.
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for way, ctx in (("tf32", contextlib.nullcontext),
                         ("ieee", ieee_float32)):
            with ctx():
                runs[way] = [grad_step(cfg, tb, device) for _ in range(2)]
        ieee = runs["ieee"][1]

        def against(got):
            return {"loss_rel": abs(got["loss"] - ieee["loss"])
                    / ieee["loss"],
                    "grad": scale_ratio(got["grads"], ieee["grads"], 1e-3,
                                        1e-3)}
        res = {"tf32": against(runs["tf32"][1]),
               "rerun": against(runs["ieee"][0]),
               "tf32_ms": runs["tf32"][1]["ms"], "ieee_ms": ieee["ms"]}
        st = T.create_train_state(cfg, 0, device)
        step = T.make_train_step(cfg, 1, seed=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(step(st, tb)["loss"])
        res["entry_ms"] = (time.perf_counter() - t0) * 1e3
        res["entry"] = against({"loss": loss, "grads": {
            k: p.grad.detach().cpu()
            for k, p in st.model.named_parameters()}})
    finally:
        torch.backends.cudnn.deterministic = deterministic
    spread = max(2 * res["rerun"]["grad"]["ratio"], 1e-3)
    if res["entry"]["loss_rel"] > max(2 * res["rerun"]["loss_rel"], 1e-6) \
            or res["entry"]["grad"]["ratio"] > spread:
        raise AssertionError(f"train_step with TF32 allowed is not the "
                             f"IEEE step: {res}")
    eb = next(val.batches(cfg.batch_size))
    eb["valid"] = eb["valid"].astype(np.float32)
    eb = T.to_device(eb, device)
    st = T.create_train_state(cfg, 0, device)
    st.model.eval()
    with torch.inference_mode():
        outs = {}
        for way, ctx in (("tf32", contextlib.nullcontext),
                         ("ieee", ieee_float32)):
            with ctx():
                outs[way] = [o.cpu() for o in T.forward(st.model, cfg, eb)]
    seen = []
    h = st.model.register_forward_hook(
        lambda m, a, out: seen.extend(o.cpu() for o in out))
    try:
        T.make_eval_step(cfg)(st, eb)
    finally:
        h.remove()
    res["eval_tf32"] = float32_bars(outs["tf32"], outs["ieee"])
    res["eval_entry"] = float32_bars(seen, outs["ieee"])
    if res["eval_entry"]["key_d"] > 1e-6 or res["eval_entry"]["tonic_d"] \
            > 1e-6:
        raise AssertionError(f"eval_step with TF32 allowed is not the IEEE "
                             f"forward: {res['eval_entry']}")
    log(f"[4p precision] train step of {batch['mel'].shape[0]} x "
        f"{batch['mel'].shape[1]} songs (phase 6's corpus) computed "
        f"directly, TF32 allowed vs IEEE float32: "
        + step_text(res["tf32"]) + f"; IEEE run to run: "
        + step_text(res["rerun"]) + f"; step {res['tf32_ms']:.1f} ms "
        f"TF32 allowed, {res['ieee_ms']:.1f} ms IEEE (forward and backward, "
        f"no Adam; deterministic cuDNN algorithms); train_step under TF32 allowed vs IEEE: "
        + step_text(res["entry"]) + f" (bar: twice the IEEE run to run,"
        f" at least 1e-3), {res['entry_ms']:.1f} ms with Adam; eval forward "
        f"TF32 allowed vs IEEE: {bars_text(res['eval_tf32'])}; eval_step "
        f"under TF32 allowed vs the IEEE forward: key |d| "
        f"{res['eval_entry']['key_d']:.3g}, tonic |d| "
        f"{res['eval_entry']['tonic_d']:.3g} (bar 1e-6) ({card_line()})")
    return res


def features_both_ways(waves, device) -> dict:
    """The dataset's CQT on the plain path (use_pallas_cqt "off": its
    decimation and response are cuBLAS matmuls, which torch's defaults
    keep in IEEE float32), directly under torch's defaults, with TF32
    for matmuls too (tf32_everywhere) and IEEE; and through
    KeyDataset._features under tf32_everywhere, which must give the IEEE
    CQT."""
    cfg = Config(use_pallas_cqt="off")
    ds = KeyDataset(False, cfg, blacklist_path="", use_cache=False,
                    device=device)
    y = torch.from_numpy(np.stack(waves)).to(device)
    p = C.CQTParams(sr=SR, hop=C.reference_hop(SR, cfg.frames))
    with torch.inference_mode():
        r = both_ways(lambda: compute_cqt(y, p, conv_dtype=cfg.cqt_conv_dtype
                                          ).cpu(), reps=5,
                      ways=("tf32", "tf32_everywhere", "ieee"))
    with tf32_everywhere():
        entry = torch.from_numpy(ds._features(y, p))
    peak = float(r["ieee"].abs().max())
    for way in ("tf32", "tf32_everywhere"):
        r[way + "_d"] = float((r[way] - r["ieee"]).abs().max())
    r["entry_d"] = float((entry - r["ieee"]).abs().max())
    if r["entry_d"] > 1e-6 * peak:
        raise AssertionError(f"KeyDataset._features with TF32 allowed: "
                             f"|d| {r['entry_d']} from the IEEE CQT")
    log(f"[4p precision] dataset CQT on the plain path ({len(waves)} x "
        f"{CLIP_SECONDS} s, {cfg.cqt_conv_dtype} streams) against IEEE "
        f"float32: max |d| {r['tf32_d']:.3g} under torch's defaults, "
        f"{r['tf32_everywhere_d']:.3g} with TF32 for matmuls too (peak "
        f"{peak:.3f}; bf16 stream bar 2% of it); {r['tf32_ms']:.3f}, "
        f"{r['tf32_everywhere_ms']:.3f} and {r['ieee_ms']:.3f} ms IEEE; "
        f"KeyDataset._features with TF32 for matmuls too vs IEEE: max |d| "
        f"{r['entry_d']:.3g} (bar 1e-6 of the peak)")
    return r


class FlagLog(logging.Handler):
    """Prints each entry point's one log line of the settings it ran
    under (utils/precision)."""

    def emit(self, record):
        log(f"[4p precision] log: {record.getMessage()}")


def run_precision(waves, first: dict, val, device) -> dict:
    """Phase 4p: what TF32 does to float32 on the card, with no
    process-wide setting (torch's defaults): the default model's, the
    resblock variant's (cuDNN-heavy) and the bf16 model's forward on
    phase 4's clips, the dataset's plain CQT, and one train step on phase
    6's corpus, each computed directly both ways; then each entry point
    (KeyEstimator.outputs, train_step, eval_step, KeyDataset._features)
    with TF32 allowed globally, which must give the IEEE numbers."""
    if precision.flags()["cudnn.conv"] != "tf32":
        raise AssertionError(f"phase 4p needs torch's defaults, found "
                             f"{precision.flags()}")
    t0 = time.perf_counter()
    waves = [pcm16(w) for w in waves]        # as phase 4's WAVs decode
    res = {name: forward_both_ways(name, Config(fused_convstack=True, **kw),
                                   waves, device)
           for name, kw in (("default", {}),
                            ("resblock", dict(resblock=True)),
                            ("bf16", dict(dtype="bfloat16")))}
    if res["bf16"]["bars"]["key_d"] > WAV_KEY:
        raise AssertionError(f"bf16 model moved by TF32: {res['bf16']}")
    res["features"] = features_both_ways(waves, device)
    res["train"] = train_both_ways(Config(fused_convstack=True), first, val,
                                   device)
    log(f"[4p precision] phase wall {time.perf_counter() - t0:.1f} s")
    return res


# ---------------------------------------------------------------------------
# phase 4b: served batches of 64-1024 clips in the 60, 180 and 420 s buckets
# ---------------------------------------------------------------------------

# (name, clip seconds, clips): the 180 s bucket at B = 64, 256 and the
# JAX package's served 1024, the 60 s and 420 s buckets
BATCHES = (("b64_180s", 120, 64), ("b256_180s", 120, 256),
           ("b1024_180s", 120, 1024), ("b256_60s", 45, 256),
           ("b64_420s", 400, 64), ("b256_420s", 400, 256))
GAINS = (1.0, 0.8, 0.6, 0.45)
ROW_SHIFT = 2749                       # samples between a base's rows


def batch_rows(seconds: int, n: int) -> list[np.ndarray]:
    """n distinct int16 clips of `seconds`: phase 4's 16 base tones made
    2 s longer, each at 4 gains; row r is base r % 16 at gain
    (r // 16) % 4 from sample (r // 64) * ROW_SHIFT, a view (no copy), so
    the first rows of a larger batch are those of a smaller one."""
    base = [[pcm16(w * g) for g in GAINS] for w in clips(BATCH, seconds + 2)]
    L = seconds * SR
    return [base[r % 16][(r // 16) % 4][(r // 64) * ROW_SHIFT:][:L]
            for r in range(n)]


def mem_available_gib() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2**20
    raise AssertionError("/proc/meminfo has no MemAvailable")


def timed_serve(est: KeyEstimator, rows) -> dict:
    """est.predict_waveforms(rows) counted (launches, wall), with its peak
    device memory and its stages (pack + H2D: make_batch; CQT: features;
    model: the replica's forward), each ending in a synchronize. Keeps
    the device batch, seq lengths and hop for the checks after."""
    t, keep = {}, {}
    make_batch, features = est.make_batch, est.features

    def timed(key, fn):
        def run(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            t[key] = (time.perf_counter() - t0) * 1e3
            return out
        return run

    def batching(*a):
        out = timed("pack+H2D", make_batch)(*a)
        keep["batch"], keep["seq"], keep["hop"] = out
        return out

    def model_pre(m, a):
        torch.cuda.synchronize()
        t["model0"] = time.perf_counter()

    def model_post(m, a, out):
        torch.cuda.synchronize()
        t["model"] = (time.perf_counter() - t.pop("model0")) * 1e3
    hooks = [est.model.register_forward_pre_hook(model_pre),
             est.model.register_forward_hook(model_post)]
    est.make_batch, est.features = batching, timed("CQT", features)
    torch.cuda.reset_peak_memory_stats()
    try:
        preds, launches, wall = counted(
            lambda: est.predict_waveforms(rows, SR, return_raw=True))
    finally:
        del est.make_batch, est.features
        for h in hooks:
            h.remove()
    return {"preds": preds, "launches": launches, "wall_ms": wall * 1e3,
            "peak": torch.cuda.max_memory_allocated(), "stages": t, **keep}


@ieee_float32()
def hold_sampled(name: str, est: KeyEstimator, served: dict, idx) -> dict:
    """The served batch's kernel work on rows idx, against the plain
    versions: the CQT of the whole batch again (kernels A and B at the
    batch's B) at those rows against the plain cqt of their signal, at
    check_cqt's bars; the model again on that CQT, every kernel C stack's
    input and output at those rows recorded by hooks, the output against
    fused_convstack_plain of the input (max rel < 5e-2, mean rel < 1e-2),
    and the keys equal to the served call's."""
    cfg = est.cfg
    sd = torch_dtype(cfg.cqt_conv_dtype)
    batch, seq, hop = served["batch"], served["seq"], served["hop"]
    rows = torch.tensor(idx, device=batch.device)
    stacks = []
    hooks = []
    for m in kernel_stacks(est.model, "conv7_layer"):
        hooks.append(m.register_forward_pre_hook(
            lambda m, a: stacks.append([m, a[0][rows].clone()])))
        hooks.append(m.register_forward_hook(
            lambda m, a, out: stacks[-1].append(out[rows].clone())))
    try:
        with torch.inference_mode():
            mels = est.features(batch, SR, hop)
            key = est.model(*mels, seq)[0][rows].cpu()
            p = C.CQTParams(sr=SR, hop=hop, octaves=cfg.octaves)
            res = {"cqt_d": check_cqt(f"{name}: CQT rows", mels[0][rows, ..., 0],
                                      C.cqt(batch[rows], p, stream_dtype=sd),
                                      sd)}
            del mels
            res["stack_rel"] = res["stack_mean_rel"] = 0.0
            for m, x, out in stacks:
                ref = m.kernel.plain(
                    x, m.kernel.operands(m.conv_pairs())).float()
                d = (out.float() - ref).abs()
                rel = float(d.max() / ref.abs().max())
                mean_rel = float(d.mean() / ref.abs().mean())
                if not (rel < 5e-2 and mean_rel < 1e-2):
                    raise AssertionError(f"{name}: stack {tuple(x.shape)} "
                                         f"max rel {rel:.3g}, mean rel "
                                         f"{mean_rel:.3g}")
                res["stack_rel"] = max(res["stack_rel"], rel)
                res["stack_mean_rel"] = max(res["stack_mean_rel"], mean_rel)
    finally:
        for h in hooks:
            h.remove()
    served_key = torch.from_numpy(np.stack(
        [served["preds"][i].key_probs for i in idx]))
    res["rerun_key_d"] = float((key - served_key).abs().max())
    res["stacks"] = len(stacks)
    if len(stacks) != 1 or res["rerun_key_d"] > 1e-6:
        raise AssertionError(f"{name}: {len(stacks)} stacks, keys again "
                             f"|d| {res['rerun_key_d']}")
    return res


@ieee_float32()
@torch.inference_mode()
def kernel_times(y: torch.Tensor, layers, T_: int) -> dict:
    """Kernels A (7 octave steps), B and C (fused_convstack) at this
    batch's B: card ms from a CUDA graph, beside the bound from phase 3's
    byte and operation counts (cqt_bounds, stack_bytes). C runs on a
    random (B, 5, 288, T) float32 input with the served stack's
    weights."""
    p = C.CQTParams(sr=SR, hop=C.reference_hop(SR, Config().frames))
    n_fft = C.kernel_bank(p)["n_fft"]
    head = n_fft // 2
    B, L = y.shape
    lay = K.arena_layout(L, p.octaves, n_fft)
    in_scale = C.input_scale(y)
    c = K._constants(p, 1 + L // p.hop, in_scale, str(y.device))
    x0 = C.pad_stream(y, head, lay.lengths[0])
    sd = torch.bfloat16
    arena = K.cascade_arena(x0, lay, head, in_scale, sd)
    streams = K.octave_streams(x0, arena, lay)
    out = torch.empty(B, p.n_bins, 1 + L // p.hop, device=y.device)
    reps, repeat = (5, 1) if B > 256 else (10, 2)

    def a_steps():
        for o in range(1, p.octaves):
            K.cascade_pad(streams[o - 1], head, lay.lens[o - 1],
                          lay.lens[o], streams[o],
                          C.decimation_taps(o, in_scale))
    res = {"A": graph_ms(a_steps, reps, repeat),
           "B": graph_ms(lambda: K.octave_response(
               x0, arena, lay, c.starts, c.bank, c.scales, out), reps,
               repeat)}
    ba, bb = cqt_bounds(y, p, lay, sd, c.starts)
    del x0, arena, streams, out
    x = torch.randn(B, 5, 288, T_, device=y.device)
    res["C"] = graph_ms(lambda: CS.fused_convstack(x, layers), reps, repeat)
    del x
    bc = bound(stack_bytes(B, 288, T_, 5, len(layers)),
               sum(2 * B * 288 * T_ * 8 * w.shape[1] * 49 for w, _ in layers),
               BF16_FLOPS)
    return {k: {"card_ms": res[k], **b}
            for k, b in (("A", ba), ("B", bb), ("C", bc))}


def serve_batch(name: str, seconds: int, rows, est: KeyEstimator,
                plain: KeyEstimator) -> dict:
    """One batch of the n = len(rows) distinct clips of `seconds` through
    est.predict_waveforms (what predict_files runs after decode): launches
    as expected_launches says (A 7 / B 1 / C 3 at every B); peak device
    memory per batch and clip; the host's MemAvailable before; wall, pack
    + H2D, CQT and model ms; audio-min/s. The first 16 rows and the last
    16 (the last real row among them): each 16 served again alone (keys
    within 3e-2; the largest |d| printed), the batch's CQT and kernel C
    stack at those rows against the plain versions (hold_sampled), their
    keys against the plain path (agreement). Then each kernel's card ms
    at this B beside its bound."""
    t0 = time.perf_counter()
    n = len(rows)
    mem = mem_available_gib()
    s = timed_serve(est, rows)
    if s["launches"] != expected_launches(est):
        raise AssertionError(f"{name}: launches {s['launches']}, the gate "
                             f"says {expected_launches(est)}")
    key = np.stack([q.key_probs for q in s["preds"]])
    if key.shape != (n, 12) or not np.isfinite(key).all():
        raise AssertionError(f"{name}: keys {key.shape}")
    idx = list(range(16)) + list(range(n - 16, n))
    alone = []
    for lo in (0, n - 16):
        again = est.predict_waveforms(rows[lo:lo + 16], SR, return_raw=True)
        alone.append(float(np.abs(np.stack([q.key_probs for q in again])
                                  - key[lo:lo + 16]).max()))
    if max(alone) >= 3e-2:
        raise AssertionError(f"{name}: rows served in 16s |d| {alone}")
    held = hold_sampled(name, est, s, idx)
    agree = agreement(name, [s["preds"][i] for i in idx],
                      plain.predict_waveforms([rows[i] for i in idx], SR,
                                              return_raw=True),
                      (len(idx), 12))
    stack = kernel_stacks(est.model, "conv7_layer")[0]
    with torch.inference_mode():
        layers = stack.kernel.operands(stack.conv_pairs())
    times = kernel_times(s["batch"], layers,
                         1 + s["batch"].shape[1] // s["hop"])
    del layers
    bucket = s["batch"].shape[1] / SR
    del s["batch"], s["seq"]
    torch.cuda.empty_cache()
    res = {"launches": s["launches"], "wall_ms": s["wall_ms"],
           "stages": s["stages"], "peak_gib": s["peak"] / 2**30,
           "peak_mib_per_clip": s["peak"] / 2**20 / n,
           "mem_available_gib": mem, "alone_key_d": max(alone),
           "audio_min_s": n * seconds / 60 / (s["wall_ms"] / 1e3),
           "bucket_s": bucket, "held": held, **agree, "kernels": times}
    log(f"[4b batch] {name}: {n} clips of {seconds} s in the {bucket:.0f} s "
        f"bucket through predict_waveforms: launches A "
        f"{s['launches']['cascade_pad']} B {s['launches']['octave_response']}"
        f" C {s['launches']['conv7_layer']}; wall {s['wall_ms']:.1f} ms = "
        f"{res['audio_min_s']:.1f} audio-min/s ("
        + ", ".join(f"{k} {v:.1f} ms" for k, v in s["stages"].items())
        + f"); peak {res['peak_gib']:.2f} GiB = "
        f"{res['peak_mib_per_clip']:.1f} MiB a clip (max_memory_allocated),"
        f" host MemAvailable before {mem:.1f} GiB; rows 0-15 and "
        f"{n - 16}-{n - 1} served again in 16s: key |d| {max(alone):.3g} "
        f"(bar 3e-2); at those rows the batch's CQT vs plain max|d| "
        f"{held['cqt_d']:.3g}, kernel C stack vs plain max rel "
        f"{held['stack_rel']:.3g} mean rel {held['stack_mean_rel']:.3g}, "
        f"{agreement_text(agree)}; on the card at this B: "
        + ", ".join(f"{k} {v['card_ms']:.4f} ms (bound {v['bound_ms']:.4f} "
                    f"ms, {v['bound_by']}, "
                    f"{v['bound_ms'] / v['card_ms']:.1%})"
                    for k, v in times.items())
        + f"; {time.perf_counter() - t0:.1f} s ({card_line()})")
    return res


def run_batches(device) -> dict:
    """Phase 4b: the default model (seeded weights, kernels A, B and C)
    serving each of BATCHES, beside the plain path on sampled rows."""
    t0 = time.perf_counter()
    cfg = Config(fused_convstack=True)
    weights = seeded_weights(cfg)
    est = KeyEstimator(cfg, weights, device=device)
    plain = KeyEstimator(cfg.replace(use_pallas_cqt="off",
                                     fused_convstack=False),
                         weights, device=device)
    res, rows = {}, {}
    for name, seconds, n in BATCHES:
        if len(rows.get(seconds, ())) < n:
            rows = {seconds: batch_rows(seconds, max(
                b for _, s, b in BATCHES if s == seconds))}
        res[name] = serve_batch(name, seconds, rows[seconds][:n], est, plain)
    log(f"[4b batch] phase wall {time.perf_counter() - t0:.1f} s")
    return res


@ieee_float32()
def stage_ms(est: KeyEstimator, paths) -> dict:
    """Split one predict_files call into decode, batch + H2D, CQT and
    model, each stage ending in torch.cuda.synchronize(); float32 in IEEE
    float32, as KeyEstimator.outputs computes it."""
    t = [time.perf_counter()]
    decoded = list(audio_io.decode_many(paths, raw=True))
    t.append(time.perf_counter())
    sr = decoded[0][1]
    batch, seq, hop = est.make_batch([w for w, _ in decoded], sr)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    with torch.inference_mode():
        mels = est.features(batch, sr, hop)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        est.model(*mels, seq)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
    names = ("decode", "batch+H2D", "cqt", "model")
    return {n: (b - a) * 1e3 for n, a, b in zip(names, t, t[1:])}


# torch.profiler on the H100 (torch 2.11, CUDA 12.8) drops the device rows
# of a session's first launches, more of them the longer the process has
# run (PERF.md section 7). A profiled call is therefore preceded by
# PAD_LAUNCHES one-element kernels, whose rows take that loss and are left
# out of every sum.
PAD_LAUNCHES = 1024


def profiled(fn) -> dict:
    """fn() once under torch.profiler, after PAD_LAUNCHES one-element
    kernels: the profile, fn's device rows (kernels and copies; the pads'
    left out), fn's kernel launches (the runtime's launch calls on the
    host), how many of them have no device row under the same
    correlation id (`unrecorded`: the trace lost some of fn's records),
    and how many pad rows the trace lost (`pads_lost`)."""
    pad = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        for _ in range(PAD_LAUNCHES):
            pad.add_(1.0)
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    launches = sorted((e for e in events if e.device_type != cuda
                       and "LaunchKernel" in e.name),
                      key=lambda e: e.time_range.start)
    pads = {e.id for e in launches[:PAD_LAUNCHES]}
    ours = {e.id for e in launches[PAD_LAUNCHES:]}
    recorded = {e.id for e in events if e.device_type == cuda}
    return {"prof": prof,
            "rows": [e for e in events
                     if e.device_type == cuda and e.id not in pads],
            "launch_records": len(ours),
            "unrecorded": len(ours - recorded),
            "pads_lost": len(pads - recorded)}


# kernel C's device rows by their demangled name, `void (anonymous
# namespace)::conv7_kernel<IN, OUT>(...)`: anchored, so that no other
# kernel whose name holds the substring is taken for it
KERNEL_C_ROW = re.compile(r"(?<!\w)conv7_kernel<")


def device_rows(fn) -> dict:
    """fn() once as a warm-up, then once profiled (profiled): its device
    rows only (kernels and copies; the host's aten rows carry the same
    time again), summed by name, with kernel C's rows apart."""
    fn()
    torch.cuda.synchronize()
    p = profiled(fn)
    rows = {}
    conv7 = 0
    conv7_us = 0.0
    for e in p["rows"]:
        us = e.time_range.elapsed_us()
        rows[e.name] = rows.get(e.name, 0.0) + us / 1e3
        if KERNEL_C_ROW.search(e.name):
            conv7 += 1
            conv7_us += us
    return {"total_ms": sum(rows.values()), "kernels": len(p["rows"]),
            "conv7_ms": conv7_us / 1e3, "conv7_launches": conv7,
            "launch_records": p["launch_records"],
            "unrecorded": p["unrecorded"], "pads_lost": p["pads_lost"],
            "top": sorted(rows.items(), key=lambda kv: -kv[1])[:5],
            "conv_fp32": precision.flags()["cudnn.conv"]}


@ieee_float32()
def model_split(name: str, est: KeyEstimator, paths, with_conv7: bool = True,
                local: bool = False) -> dict:
    """The model stage of one served batch on the card (global or local
    mode): one profiled pass over est.model (or est.local_model), kernel
    C's rows (which must be there when with_conv7, and absent otherwise)
    against the rest and the largest rows by name (device_rows); every
    launch of the pass must have its device row. For the multi-scale
    ensemble also each tower alone on its own CQT (`towers`: model1 at
    36, model2 at 12 bins/octave). float32 in IEEE float32, as
    KeyEstimator.outputs computes it."""
    decoded = list(audio_io.decode_many(paths, raw=True))
    sr = decoded[0][1]
    batch, seq, hop = est.make_batch([w for w, _ in decoded], sr)
    net = est.local_model if local else est.model
    with torch.inference_mode():
        mels = est.features(batch, sr, hop)
        res = device_rows(lambda: net(*mels, seq))
        if not res["kernels"] or res["unrecorded"] \
                or bool(res["conv7_launches"]) != with_conv7:
            raise AssertionError(
                f"{name}: profiler saw {res['kernels']} device rows, "
                f"{res['conv7_launches']} of kernel C, "
                f"{res['unrecorded']} of {res['launch_records']} launches "
                f"without a device row ({res['pads_lost']} of "
                f"{PAD_LAUNCHES} pad rows lost)")
        if est.cfg.multi_scale:
            res["towers"] = {
                k: device_rows(lambda t=tower, m=mel: t(m, seq))
                for k, tower, mel in (("model1", net.model1, mels[0]),
                                      ("model2", net.model2, mels[1]))}
            lost = {k: t["unrecorded"] for k, t in res["towers"].items()}
            if any(lost.values()):
                raise AssertionError(f"{name}: launches without a device "
                                     f"row, by tower: {lost}")
    return res


def towers_text(split: dict) -> str:
    """Each tower's device ms: kernel C against the rest (cuDNN's convs
    and the other kernels) and its largest row."""
    if "towers" not in split:
        return ""
    return "; towers: " + ", ".join(
        f"{k} {t['total_ms']:.3f} ms (kernel C {t['conv7_ms']:.3f} ms in "
        f"{t['conv7_launches']} launches, the rest "
        f"{t['total_ms'] - t['conv7_ms']:.3f} ms, largest "
        f"{t['top'][0][0][:40]} {t['top'][0][1]:.3f} ms)"
        for k, t in split["towers"].items())


# ---------------------------------------------------------------------------
# phase 5: dataset preprocessing
# ---------------------------------------------------------------------------

GS_SR = 44100            # GiantSteps audio
WR_SR = 22050
# spellings in the loaders' vocabularies (GiantSteps: flats)
GS_KEYS = [f"{n} {m}" for m in ("major", "minor")
           for n in ("C", "Db", "D", "Eb", "E", "F", "Gb", "G", "Ab", "A",
                     "Bb", "B")]
WR_KEYS = [f"{n}:{m}" for m in ("maj", "min")
           for n in ("C", "C#", "D", "Eb", "E", "F", "F#", "G", "Ab", "A",
                     "Bb", "B")]
DATASET_COUNTERS = (K.cascade_pad, K.octave_response)


class Tones:
    """Song audio: two partials of a per-song pitch plus noise, as
    clips() makes it, at any rate and length. The first 10 s are
    computed and repeated to the song's length, so writing the phase's
    two hours of audio costs the host seconds, not tens of seconds."""

    def __init__(self, seed: int = 1):
        self.rng = np.random.default_rng(seed)

    def __call__(self, sr: int, seconds: float, i: int) -> np.ndarray:
        n = int(round(sr * seconds))
        t = np.arange(min(n, 10 * sr)) / sr
        f0 = 110.0 * 2 ** (i / 7)
        y = (0.4 * np.sin(2 * np.pi * f0 * t)
             + 0.2 * np.sin(2 * np.pi * 1.5 * f0 * t)).astype(np.float32)
        y += 0.05 * self.rng.standard_normal(len(t), dtype=np.float32)
        return np.resize(0.5 * y, n)


def build_corpora(root: str) -> dict:
    """The dataset phase's corpora, written with the port's
    data/synthetic.py, each imported as one group of songs:
      gs_pcm16   16 x 120 s, 44.1 kHz, PCM16 (GiantSteps layout, genres);
      gs_float   16 x 120 s, 44.1 kHz, float32 and 24-bit WAV;
      winterreise  16 songs of 60-420 s at 22050 Hz in PCM16, float32
                 and 24-bit WAV, each with two or three local key
                 segments (Winterreise layout);
      window     4 songs of 61-188 s at 44.1 kHz (PCM16 and float32), for
                 the frames == 0 (window_size) mode and the cache.
    Returns name -> (root, seconds of audio)."""
    tones = Tones()
    genres = loaders.GiantStepsKeyLoader.GENRES
    out = {}

    def giantsteps(name, encs, seconds):
        songs = [(f"{name}_{i:02d}", 0.0, GS_KEYS[(5 * i) % 24],
                  genres[i % len(genres)])
                 for i in range(len(encs))]
        d = synthetic.make_giantsteps_corpus(
            os.path.join(root, name), songs,
            audio_fn=lambda p, key, i: write_encoded(
                p, tones(GS_SR, seconds[i], i), GS_SR, encs[i]))
        out[name] = (d, float(sum(seconds)))

    giantsteps("gs_pcm16", ["pcm16"] * 16, [120.0] * 16)
    giantsteps("gs_float", ["f32", "s24"] * 8, [120.0] * 16)
    giantsteps("window", ["pcm16", "f32"] * 2,
               [61.3, 97.7, 143.1, 187.9])
    wr_seconds = [60.0 + 24 * i + 0.37 * (i % 5) for i in range(16)]
    songs = [(f"P{i:02d}", f"D911-{i + 1:02d}", 0.0, WR_KEYS[(7 * i) % 24])
             for i in range(16)]
    segments = {}
    for i, (perf, song, _, key) in enumerate(songs):
        s = wr_seconds[i]
        cuts = [0.0, round(s * 0.4, 1)] + ([round(s * 0.75, 1)]
                                           if i % 2 else []) + [s]
        keys = [key, WR_KEYS[(7 * i + 7) % 24], WR_KEYS[(7 * i + 14) % 24]]
        segments[f"{perf}_{song}"] = [(a, b, keys[j]) for j, (a, b) in
                                      enumerate(zip(cuts, cuts[1:]))]
    names = [f"{p}_{s}" for p, s, _, _ in songs]
    d = synthetic.make_winterreise_corpus(
        os.path.join(root, "winterreise"), songs, local_segments=segments,
        audio_fn=lambda p, name, segs: write_encoded(
            p, tones(WR_SR, wr_seconds[names.index(name)],
                     names.index(name)), WR_SR,
            ENCODINGS[names.index(name) % 3]))
    out["winterreise"] = (d, float(sum(wr_seconds)))
    return out


def timed_import(ds: KeyDataset, loader) -> dict:
    """ds.import_data(loader) with every kernel count set to 0 just
    before and read just after, its wall split into decode (the time
    spent in decode_many's generator), pack + H2D (ds._batch), CQT and
    readback (ds._features) and labels (ds._finish_item), each stage
    ending in a synchronize; and each CQT call's launches, batch and
    bins/octave."""
    t = {"decode": 0.0, "pack+H2D": 0.0, "CQT": 0.0, "labels": 0.0}
    calls = []
    decode_many = audio_io.decode_many
    batch, features, finish = ds._batch, ds._features, ds._finish_item

    def timed(key, fn):
        def run(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            t[key] += time.perf_counter() - t0
            return out
        return run

    def decoding(*a, **kw):
        it = decode_many(*a, **kw)
        while True:
            t0 = time.perf_counter()
            try:
                x = next(it)
            except StopIteration:
                return
            finally:
                t["decode"] += time.perf_counter() - t0
            yield x

    def counting(y, p):
        before = [c.launches for c in DATASET_COUNTERS]
        out = timed("CQT", features)(y, p)
        calls.append({"launches": [c.launches - b for c, b in
                                   zip(DATASET_COUNTERS, before)],
                      "batch": tuple(y.shape), "dtype": y.dtype,
                      "bpo": p.bins_per_octave, "hop": p.hop})
        return out

    ds._batch, ds._features = timed("pack+H2D", batch), counting
    ds._finish_item = timed("labels", finish)
    audio_io.decode_many = decoding
    gc.collect()              # as in counted()
    for c in DATASET_COUNTERS:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        ds.import_data(loader, progress=False)
        torch.cuda.synchronize()
    finally:
        audio_io.decode_many = decode_many
        del ds._batch, ds._features, ds._finish_item
    wall = time.perf_counter() - t0
    return {"wall": wall, "split": t, "calls": calls,
            "launches": {c.__name__: c.launches for c in DATASET_COUNTERS}}


def check_dataset_launches(name: str, run: dict, kernels: bool,
                           octaves: int) -> None:
    """Kernels on: A octaves-1 and B 1 launches per CQT call (one call per
    group and bins/octave); off: none."""
    want = [octaves - 1, 1] if kernels else [0, 0]
    bad = [c for c in run["calls"] if c["launches"] != want]
    if not run["calls"] or bad:
        raise AssertionError(f"dataset {name}: CQT calls {run['calls']}, "
                             f"each must launch A/B {want}")


def hold_dataset(name: str, got: KeyDataset, ref: KeyDataset) -> dict:
    """The kernel run's dataset against the plain run's: every item's mel
    (and mel2) at check_cqt's bars for the stream dtype; labels, genre,
    window coverage, seq_length and every other batches() array equal."""
    sd = torch_dtype(got.cfg.cqt_conv_dtype)
    if [it["file"] for it in got.items] != [it["file"] for it in ref.items]:
        raise AssertionError(f"dataset {name}: items differ")
    d = {"mel": 0.0, "mel2": 0.0}
    for g, r in zip(got.items, ref.items):
        if sorted(g) != sorted(r):
            raise AssertionError(f"dataset {name}: keys {sorted(g)} vs "
                                 f"{sorted(r)}")
        for k in r:
            if k in d:
                d[k] = max(d[k], check_cqt(
                    f"dataset {name} {os.path.basename(r['file'])} {k}",
                    torch.from_numpy(g[k]), torch.from_numpy(r[k]), sd))
            elif not np.array_equal(g[k], r[k]):
                raise AssertionError(f"dataset {name}: {k} differs for "
                                     f"{r['file']}")
    for bs in (16, 5):
        for gb, rb in zip(got.batches(bs), ref.batches(bs), strict=True):
            for k in rb:
                if k not in d and not np.array_equal(gb[k], rb[k]):
                    raise AssertionError(f"dataset {name}: batches({bs}) "
                                         f"{k} differs")
    return d


def split_text(run: dict) -> str:
    return ", ".join(f"{k} {v * 1e3:.1f}" for k, v in run["split"].items())


def dataset_pair(name, root, seconds, loader_of, cfg, genre, device) -> dict:
    """One corpus imported twice on the card, use_cache=False: the kernels
    (use_pallas_cqt="on") and the plain CQT ("off"); launches checked,
    the kernel run held against the plain run (hold_dataset)."""
    runs, sets = {}, {}
    for mode in ("on", "off"):
        ds = KeyDataset(genre, cfg.replace(use_pallas_cqt=mode),
                        blacklist_path="", use_cache=False, device=device)
        runs[mode] = timed_import(ds, loader_of(root))
        check_dataset_launches(name, runs[mode], mode == "on", cfg.octaves)
        sets[mode] = ds
    held = hold_dataset(name, sets["on"], sets["off"])
    n = len(sets["on"])
    on, off = runs["on"], runs["off"]
    groups = "; ".join(
        f"{c['batch']} {str(c['dtype']).split('.')[-1]} {c['bpo']} bpo hop "
        f"{c['hop']}" for c in on["calls"])
    log(f"[5 dataset] {name}: {n} songs, {seconds / 60:.1f} audio-min, "
        f"CQT calls [{groups}], launches A {on['launches']['cascade_pad']} B "
        f"{on['launches']['octave_response']} (plain run 0/0); "
        f"import_data {on['wall'] * 1e3:.1f} ms ({split_text(on)} ms) = "
        f"{n / on['wall']:.2f} songs/s, {seconds / 60 / on['wall']:.1f} "
        f"audio-min/s; plain {off['wall'] * 1e3:.1f} ms ({split_text(off)} "
        f"ms) = {n / off['wall']:.2f} songs/s, "
        f"{seconds / 60 / off['wall']:.1f} audio-min/s; mel max|d| "
        f"{held['mel']:.3g}" + (f", mel2 {held['mel2']:.3g}"
                                if cfg.multi_scale else "")
        + f" ({cfg.cqt_conv_dtype} streams; labels, coverage, seq_length "
        f"and batches equal) ({card_line()})")
    return {"songs": n, "seconds": seconds, "on": on, "off": off,
            "held": held}


def dataset_cache(root: str, cfg: Config, device) -> dict:
    """One import with use_cache=True writes a `_cuda` sidecar per song
    (and no plain-named one); a second import reads every one back
    unchanged and launches no kernel."""
    gs = loaders.GiantStepsKeyLoader
    first = KeyDataset(False, cfg, blacklist_path="", device=device)
    r1 = timed_import(first, gs(root))
    check_dataset_launches("cache, first import", r1, True, cfg.octaves)
    for it in first.items:
        side = first.cache_path(it["file"], cfg.bins_per_octave)
        plain = dataset_cache_path(it["file"], cfg, cfg.bins_per_octave)
        if "_cuda" not in side or not os.path.exists(side) \
                or os.path.exists(plain):
            raise AssertionError(f"dataset cache: sidecar {side} "
                                 f"(plain-named {plain})")
    again = KeyDataset(False, cfg, blacklist_path="", device=device)
    r2 = timed_import(again, gs(root))
    if r2["calls"] or any(r2["launches"].values()):
        raise AssertionError(f"dataset cache reread launched "
                             f"{r2['launches']} in {r2['calls']}")
    for a, b in zip(first.items, again.items, strict=True):
        if a["file"] != b["file"] or not np.array_equal(a["mel"], b["mel"]):
            raise AssertionError(f"dataset cache: {a['file']} changed")
    log(f"[5 dataset] cache: first import {r1['wall'] * 1e3:.1f} ms wrote "
        f"{len(first)} `_cuda` sidecars (launches A "
        f"{r1['launches']['cascade_pad']} B "
        f"{r1['launches']['octave_response']}); second import "
        f"{r2['wall'] * 1e3:.1f} ms read every one back unchanged, launches "
        f"A {r2['launches']['cascade_pad']} B "
        f"{r2['launches']['octave_response']}")
    return {"first": r1, "again": r2}


def run_dataset(td: str, device) -> dict:
    """The dataset preprocessing path on the card: three corpora of 16
    songs (one group each) imported with the kernels and with the plain
    CQT and held against each other; four songs in window_size mode
    (frames == 0, one group per song); the feature cache written and
    read back."""
    t0 = time.perf_counter()
    corpora = build_corpora(td)
    t_build = time.perf_counter() - t0
    log(f"[5 dataset] corpora written with data/synthetic.py in "
        f"{t_build:.1f} s: " + ", ".join(
            f"{k} {v[1] / 60:.1f} audio-min" for k, v in corpora.items())
        + "; no cut (48 songs in 3 groups of 16, 4 window_size songs)")
    gs = loaders.GiantStepsKeyLoader
    plan = [
        ("gs_pcm16", "", gs, Config(), True),
        ("gs_float", " (float32 streams, multi_scale mel2)", gs,
         Config(multi_scale=True, cqt_conv_dtype="float32"), True),
        ("winterreise", " (local labels)",
         lambda r: loaders.SchubertWinterreiseLoader(r, local=True),
         Config(local=True), False),
        ("window", " (frames=0)", gs, Config(frames=0), False),
    ]
    res = {}
    for name, what, loader_of, cfg, genre in plan:
        root, seconds = corpora[name]
        res[name] = dataset_pair(name + what, root, seconds, loader_of, cfg,
                                 genre, device)
    res["cache"] = dataset_cache(corpora["window"][0], Config(frames=0),
                                 device)
    main = [res[k] for k in ("gs_pcm16", "gs_float", "winterreise")]
    songs = sum(r["songs"] for r in main)
    seconds = sum(r["seconds"] for r in main)
    wall = {m: sum(r[m]["wall"] for r in main) for m in ("on", "off")}
    split = {k: sum(r["on"]["split"][k] for r in main)
             for k in main[0]["on"]["split"]}
    launches = {k: sum(r["on"]["launches"][k] for r in main)
                for k in main[0]["on"]["launches"]}
    mel_d = max(r["held"]["mel"] for r in res.values() if "held" in r)
    log(f"[5 dataset] 48 songs in 3 groups: import_data "
        f"{wall['on'] * 1e3:.1f} ms (" + ", ".join(
            f"{k} {v * 1e3:.1f}" for k, v in split.items())
        + f" ms) = {songs / wall['on']:.2f} songs/s, "
        f"{seconds / 60 / wall['on']:.1f} audio-min/s; plain CQT "
        f"{wall['off'] * 1e3:.1f} ms = {songs / wall['off']:.2f} songs/s, "
        f"{seconds / 60 / wall['off']:.1f} audio-min/s; launches A "
        f"{launches['cascade_pad']} B {launches['octave_response']}; largest "
        f"mel |d| {mel_d:.3g}, mel2 {res['gs_float']['held']['mel2']:.3g} "
        f"({card_line()})")
    return {"launches": launches,
            "window_launches": res["window"]["on"]["launches"],
            "cache_launches": res["cache"]["again"]["launches"],
            "mel_d": mel_d, "res": res}


# ---------------------------------------------------------------------------
# phase 6: training and evaluation
# ---------------------------------------------------------------------------

TRAIN_SONGS, VAL_SONGS = 64, 16


def build_train_corpora(root: str) -> dict:
    """64 training and 16 validation songs, 120 s PCM16 at 22050 Hz in
    the GiantSteps layout, written by data/synthetic.py as scale walks
    (the audio determines key and tonic). Returns name -> root."""
    genres = loaders.GiantStepsKeyLoader.GENRES
    out = {}
    for name, n, shift, offset in (("train", TRAIN_SONGS, 0, 0),
                                   ("val", VAL_SONGS, 3, 1000)):
        songs = [(f"{name}_{i:02d}", 0.0, GS_KEYS[(5 * i + shift) % 24],
                  genres[i % len(genres)]) for i in range(n)]
        out[name] = synthetic.make_giantsteps_corpus(
            os.path.join(root, name), songs, seconds=CLIP_SECONDS,
            scale_audio=True, seed_offset=offset)
    return out


def scale_ratio(got: dict, want: dict, rtol: float, floor: float) -> dict:
    """How far each tensor of `got` lies from `want` against its bar: rtol
    of that tensor's largest magnitude plus `floor` of the largest
    magnitude over all of them (a gradient that cancels to ~0, as a conv
    bias's ahead of a training-mode BatchNorm does, keeps the model's
    rounding floor). Returns the worst: its ratio (<= 1 passes), name,
    |d|, its tensor's largest magnitude and the largest over all."""
    top = max(float(v.abs().max()) for v in want.values())
    worst = {"ratio": -1.0}
    for k, v in want.items():
        d = float((got[k].float() - v.float()).abs().max())
        scale = float(v.abs().max())
        ratio = d / (rtol * scale + floor * top)
        if ratio > worst["ratio"]:
            worst = {"ratio": ratio, "name": k, "d": d, "scale": scale,
                     "top": top}
    return worst


def step_against_cpu(cfg: Config, batch: dict, device) -> dict:
    """One train step (acc_grad micro-batches, one Adam update, drop 0)
    from the same weights on the same batch, on the card and on the CPU
    (the plain PyTorch step: another device and library stack). The
    card's loss within rtol 1e-4 of the CPU's; every gradient within 1e-3
    of its tensor's largest magnitude plus 1e-3 of the model's largest;
    every BatchNorm's updated running mean within 1e-4 of its running
    standard deviation and running variance within rtol 1e-4. Bars: each
    gradient and batch statistic sums 8 x 8 x 288 x 1024 = 18.9 M float32
    terms per channel in another order and through other convolution
    algorithms (TF32 off). Where such a sum cancels (a conv ahead of a
    training-mode BatchNorm: its bias's true gradient is 0, its weight's
    is orthogonal to the weight), what is left is rounding of the terms'
    size, growing as the square root of their count: eps * sqrt(18.9 M) = 2.6e-4 here, against 8e-6 at the CPU
    tests' 18 K terms, whose floor is 1e-5; the floor here keeps the same
    ~4x room, and the relative part follows it."""
    card = T.create_train_state(cfg, 1, device)
    cpu = T.create_train_state(cfg, 1, "cpu")
    cpu.model.load_state_dict(card.model.state_dict())
    out = {}
    for name, st in (("card", card), ("cpu", cpu)):
        dev = next(st.model.parameters()).device
        step = T.make_train_step(cfg, 1, seed=0)
        tb = T.to_device(batch, dev)
        if name == "card":
            m, launches, wall = counted(lambda: step(st, tb))
            if any(launches.values()):
                raise AssertionError(f"train step launched {launches}")
        else:
            t0 = time.perf_counter()
            m = step(st, tb)
            wall = time.perf_counter() - t0
        out[name] = {"loss": float(m["loss"]), "wall": wall,
                     "grads": {k: p.grad.detach().cpu() for k, p in
                               st.model.named_parameters()},
                     "bufs": {k: b.detach().cpu() for k, b in
                              st.model.named_buffers()}}
    a, b = out["card"], out["cpu"]
    res = {"loss": a["loss"], "cpu_loss": b["loss"],
           "loss_rel": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
           "grad": scale_ratio(a["grads"], b["grads"], 1e-3, 1e-3),
           "card_s": a["wall"], "cpu_s": b["wall"]}
    res["mean_ratio"] = max(
        float(((a["bufs"][k] - v).abs() / (1e-4 * b["bufs"][k.replace(
            "running_mean", "running_var")].sqrt())).max())
        for k, v in b["bufs"].items() if k.endswith("running_mean"))
    res["var_rel"] = max(float(((a["bufs"][k] - v).abs() / v).max())
                         for k, v in b["bufs"].items()
                         if k.endswith("running_var"))
    if not (np.isfinite(a["loss"]) and res["loss_rel"] <= 1e-4
            and res["grad"]["ratio"] <= 1 and res["mean_ratio"] <= 1
            and res["var_rel"] <= 1e-4):
        raise AssertionError(f"train step, card vs CPU: {res}")
    return res


def eval_outputs(state, cfg: Config, ds) -> tuple:
    """Per-sample (key, tonic) of the eval-mode model over
    ds.batches(cfg.batch_size), the repeat-padded rows dropped, with the
    labels; rows follow ds.items. Counted: the launches of these
    forwards. float32 in IEEE float32, as eval_step computes it."""
    device = next(state.model.parameters()).device

    def run():
        rows = {k: [] for k in ("key", "tonic", "key_labels",
                                "tonic_labels", "key_signature_id")}
        state.model.eval()
        for b in ds.batches(cfg.batch_size):
            valid = torch.from_numpy(b.pop("valid"))
            tb = T.to_device(b, device)
            with torch.inference_mode(), ieee_float32():
                key, tonic = T.forward(state.model, cfg, tb)[:2]
            for k, v in (("key", key), ("tonic", tonic)) + tuple(
                    (n, tb[n]) for n in ("key_labels", "tonic_labels",
                                         "key_signature_id")):
                rows[k].append(v.cpu()[valid])
        return {k: torch.cat(v) for k, v in rows.items()}
    return counted(run)


def loss_bar(cfg: Config, out: dict) -> float:
    """First-order bound on the validation loss's change when every key
    probability moves by up to 3e-2 and every tonic logit by up to 3e-2 of
    their largest magnitude (the agreement bars): sum |dL/dkey| * 3e-2 +
    sum |dL/dtonic| * 3e-2 * max|tonic|, L the mean over songs (what
    evaluate's valid-weighted batch losses make), at the plain path's
    outputs."""
    key = out["key"].double().requires_grad_()
    tonic = out["tonic"].double().requires_grad_()
    loss, _ = compute_loss(cfg, (key, tonic),
                           {k: out[k].double() for k in
                            ("key_labels", "tonic_labels")})
    loss.backward()
    return float(key.grad.abs().sum() * 3e-2 + tonic.grad.abs().sum()
                 * 3e-2 * out["tonic"].abs().max())


def top2_margin(key: torch.Tensor) -> float:
    """Cosine of the key output to its nearest KEY_SIGNATURE_MAP row less
    that to the second nearest: how close the named key is to flipping."""
    ksm = torch.as_tensor(KEY_SIGNATURE_MAP)
    sims = F.cosine_similarity(key[None].float(), ksm, dim=1)
    top = torch.topk(sims, 2).values
    return float(top[0] - top[1])


def check_validation(state, cfg: Config, val, device,
                     min_spread: float = 0.0) -> dict:
    """The trained state's validation through kernel C against the plain
    path (the same weights in a model with fused_convstack=False) on the
    card: stack_launches' C launches per batch (3, or 6 for the
    multi-scale ensemble) and none on the plain path; per-song keys
    and tonics at the agreement bars (3e-2, tonic 3e-2 of its peak); the
    validation loss within loss_bar; songs whose MIREX categories differ
    named with their top-2 cosine margin and key |d|; evaluate's wall
    with and without kernel C. The keys' spread across songs (the largest
    range of one output) must reach min_spread, or the agreement would
    not show an error upstream (phase 4's `agreement`)."""
    plain_cfg = cfg.replace(fused_convstack=False)
    plain = T.create_train_state(plain_cfg, 0, device)
    plain.model.load_state_dict(state.model.state_dict())
    n_batches = -(-len(val) // cfg.batch_size)
    got, launches, _ = eval_outputs(state, cfg, val)
    ref, launches_plain, _ = eval_outputs(plain, plain_cfg, val)
    per_batch = stack_launches(state.model, cfg.dtype)["conv7_layer"]
    if not per_batch or launches["conv7_layer"] != per_batch * n_batches \
            or launches_plain["conv7_layer"] != 0:
        raise AssertionError(f"validation launches {launches} (plain "
                             f"{launches_plain}), want C {per_batch} per "
                             "batch")
    res = {"launches": launches, "batches": n_batches,
           "key_spread": float((ref["key"].max(0).values
                                - ref["key"].min(0).values).max()),
           "key_d": float((got["key"] - ref["key"]).abs().max()),
           "tonic_rel_d": float((got["tonic"] - ref["tonic"]).abs().max()
                                / ref["tonic"].abs().max())}
    walls = {}
    for name, st, c in (("kernel C", state, cfg),
                        ("plain", plain, plain_cfg),
                        ("kernel C again", state, cfg)):
        val_metrics, _, wall = counted(lambda: T.evaluate(
            T.make_eval_step(c), st, val, c.batch_size))
        walls[name] = wall * 1e3
        res[name] = val_metrics
    res["walls_ms"] = walls
    res["loss_d"] = abs(res["kernel C"]["loss"] - res["plain"]["loss"])
    res["loss_bar"] = loss_bar(cfg, ref)
    cats = [mirex_categories(o["key_labels"], o["key"], o["tonic_labels"],
                             o["tonic"], o["key_signature_id"])
            for o in (got, ref)]
    differ = sorted({int(i) for k in cats[0] for i in
                     torch.nonzero(cats[0][k] != cats[1][k]).flatten()})
    res["differ"] = [
        (os.path.basename(val.items[i]["file"]), top2_margin(ref["key"][i]),
         float((got["key"][i] - ref["key"][i]).abs().max()))
        for i in differ]
    if res["key_d"] >= 3e-2 or res["tonic_rel_d"] >= 3e-2 \
            or res["key_spread"] < min_spread \
            or res["loss_d"] > res["loss_bar"] \
            or not np.isfinite(res["kernel C"]["loss"]):
        raise AssertionError(f"validation, kernel C vs plain: {res}")
    return res


def validation_text(tag: str, name: str, v: dict) -> str:
    return (
        f"[6 train] {tag}validation of {name}, through kernel C vs the plain "
        f"path ({v['batches']} batches, launches C "
        f"{v['launches']['conv7_layer']}, plain 0): key |d| {v['key_d']:.3g}"
        f" (bar 3e-2; the keys spread {v['key_spread']:.3f} across songs), "
        f"tonic |d| {v['tonic_rel_d']:.3g} of its peak (bar 3e-2); val_loss "
        f"{v['kernel C']['loss']:.6f} vs {v['plain']['loss']:.6f}, |d| "
        f"{v['loss_d']:.3g} (bar {v['loss_bar']:.3g}, first order at the "
        f"agreement bars); val_mirex {v['kernel C']['mirex']:.4f} vs "
        f"{v['plain']['mirex']:.4f}; MIREX categories differ for "
        + (", ".join(f"{f} (top-2 cosine margin {m:.3g}, key |d| {d:.3g})"
                     for f, m, d in v["differ"]) or "no song")
        + "; evaluate wall " + ", ".join(
            f"{k} {w:.1f} ms" for k, w in v["walls_ms"].items())
        + f" ({card_line()})")


def train_split(state, cfg: Config, batch) -> dict:
    """One train step profiled (profiled: every launch of the step must
    have its device row): the device time of the step (kernels and
    copies) and the device time under the step's cuDNN
    forward convolutions, their backward, BatchNorm (cuDNN's forward and
    backward), the running statistics' update and the optimizer (the
    gradient average and Adam's multi-tensor kernels), from key_averages
    (each operator's device time with its children's; only operators
    that do not nest in one another are summed)."""
    step = T.make_train_step(cfg, 1, seed=0)
    step(state, batch)
    torch.cuda.synchronize()
    p = profiled(lambda: step(state, batch))
    if p["unrecorded"]:
        raise AssertionError(
            f"train step: {p['unrecorded']} of {p['launch_records']} "
            f"launches without a device row ({p['pads_lost']} of "
            f"{PAD_LAUNCHES} pad rows lost)")
    total = sum(e.time_range.elapsed_us() for e in p["rows"]) / 1e3
    groups = {
        "conv forward": ("aten::cudnn_convolution",
                         "aten::cudnn_convolution_transpose"),
        "conv backward": ("aten::convolution_backward",),
        "BatchNorm": ("aten::cudnn_batch_norm",
                      "aten::cudnn_batch_norm_backward",
                      "aten::native_batch_norm",
                      "aten::native_batch_norm_backward"),
        "BatchNorm running statistics": ("aten::var_mean",),
        # the gradient average and Adam's update: multi-tensor kernels
        "optimizer": ("aten::_foreach_",),
    }
    rows = {a.key: getattr(a, "device_time_total", 0.0)
            for a in p["prof"].key_averages()}
    split = {g: sum(t for k, t in rows.items()
                    if any(k == n or (n.endswith("_") and k.startswith(n))
                           for n in names)) / 1e3
             for g, names in groups.items()}
    split["other"] = total - sum(split.values())
    kernels = {}
    for e in p["rows"]:
        kernels[e.name] = kernels.get(e.name, 0.0) \
            + e.time_range.elapsed_us() / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:4]
    if total <= 0:
        raise AssertionError("profiler saw no device time in a train step")
    return {"total_ms": total, "split": split, "top": top,
            "pads_lost": p["pads_lost"]}


def import_train_sets(roots: dict, cfg: Config, device, tag: str) -> tuple:
    """The training and validation corpora imported by KeyDataset through
    kernels A and B (A 7, B 1 per group and bins/octave: the multi-scale
    ensemble's mel2 is a second CQT per group). Returns (train, val,
    launches, T, bucket)."""
    sets, imports = {}, {}
    for name in ("train", "val"):
        ds = KeyDataset(False, cfg, blacklist_path="", use_cache=False,
                        device=device)
        imports[name] = timed_import(ds, loaders.GiantStepsKeyLoader(
            roots[name]))
        check_dataset_launches(f"train phase {tag}{name}", imports[name],
                               True, cfg.octaves)
        bins = sorted({c["bpo"] for c in imports[name]["calls"]})
        if bins != sorted(feature_bins(cfg)):
            raise AssertionError(f"{name}: CQTs at {bins} bins/octave")
        sets[name] = ds
        t_max = max(it["mel"].shape[-1] for it in ds.items)
        if t_max != 1 + CLIP_SECONDS * cfg.frames:
            raise AssertionError(f"{name}: {t_max} frames")
    bucket = next(b for b in cfg.bucket_sizes if b >= t_max)
    launches = {k: sum(r["launches"][k] for r in imports.values())
                for k in imports["train"]["launches"]}
    log(f"[6 train] {tag}import: " + "; ".join(
        f"{n} {len(sets[n])} songs in {len(r['calls'])} CQT calls, "
        f"{r['wall'] * 1e3:.1f} ms ({split_text(r)} ms), launches A "
        f"{r['launches']['cascade_pad']} B {r['launches']['octave_response']}"
        for n, r in imports.items()))
    return sets["train"], sets["val"], launches, t_max, bucket


def run_train(roots: dict, td: str, device, cfg: Config,
              tag: str = "") -> dict:
    """Training and evaluation on the card at the Config's full widths
    (the default: 2 layers, 3 convs, 4 filters, kernel 7, 288 rows; the
    multi-scale ensemble adds model2 on 96 rows of the 12-bin CQT; batch
    8 x acc_grad 8 = 64 songs a step; T = 601 in the 1024 bucket),
    fused_convstack on, 3 epochs with the epoch -1 evaluation, checkpoints
    in a run directory: features imported by KeyDataset through kernels A
    and B (A 7, B 1 per group and CQT); Trainer.fit launching kernel C as
    stack_launches counts it per validation batch and never in a train
    step; one step held against the CPU; the validation through kernel C held
    against the plain path; one batch repeated for 10 steps (the loss must
    fall; step wall, peak memory, the step's device split); the best
    checkpoint served back through
    KeyEstimator.from_checkpoint.predict_files within 1e-3 of the
    trainer's own eval outputs of that state."""
    train, val, import_launches, t_max, bucket = import_train_sets(
        roots, cfg, device, tag)

    run_dir = os.path.join(td, "run")
    tr = T.Trainer(cfg, train, val, log_dir=run_dir, device=device)
    (state, hist), fit_launches, fit_wall = counted(
        lambda: tr.fit(seed=0, eval_at_start=True))
    n_batches = -(-len(val) // cfg.batch_size)
    per_eval = stack_launches(state.model, cfg.dtype)
    per_batch = per_eval["conv7_layer"]
    want = {"cascade_pad": 0, "octave_response": 0,
            **{k: v * n_batches * len(hist) for k, v in per_eval.items()}}
    steps = cfg.epochs * (len(train) // (cfg.batch_size * cfg.acc_grad))
    if not per_batch or fit_launches != want or state.step != steps:
        raise AssertionError(f"fit: launches {fit_launches} (want {want}), "
                             f"{state.step} steps (want {steps})")
    if not all(np.isfinite(r["val_loss"]) for r in hist) or not all(
            np.isfinite(r["train_loss"]) for r in hist[1:]):
        raise AssertionError(f"fit: non-finite losses {hist}")
    if not {"best_model.pt", "last_state.pt", "config.json"} <= set(
            os.listdir(run_dir)):
        raise AssertionError(f"run directory {os.listdir(run_dir)}")
    log(f"[6 train] {tag}Trainer.fit: {len(hist) - 1} epochs of "
        f"{steps // cfg.epochs} step(s) ({cfg.batch_size} x {cfg.acc_grad} "
        f"songs, T {t_max} in the {bucket} bucket) in {fit_wall:.2f} s, "
        f"launches "
        f"A {fit_launches['cascade_pad']} B {fit_launches['octave_response']}"
        f" C {fit_launches['conv7_layer']} ({per_batch} per validation batch"
        f" x {n_batches} batches x {len(hist)} evaluations, 0 per train "
        f"step); "
        + "; ".join(f"epoch {r['epoch']}: train_loss {r['train_loss']:.4f} "
                    f"val_loss {r['val_loss']:.4f} val_mirex "
                    f"{r['val_mirex']:.4f} ({r['epoch_seconds']:.2f} s)"
                    for r in hist))

    first = next(train.batches(cfg.batch_size * cfg.acc_grad, shuffle=True,
                               seed=0, drop_last=True))
    first.pop("valid")
    first = {k: np.reshape(v, (cfg.acc_grad, cfg.batch_size) + v.shape[1:])
             for k, v in first.items()}
    cpu = step_against_cpu(cfg, first, device)
    log(f"[6 train] {tag}one step, card vs CPU (same weights and batch, "
        f"drop 0, train_step in IEEE float32 under the caller's "
        f"{precision.flags()}): loss "
        f"{cpu['loss']:.6f} "
        f"vs {cpu['cpu_loss']:.6f} (rel {cpu['loss_rel']:.3g}, bar 1e-4); "
        f"gradients at {cpu['grad']['ratio']:.3g} of their bar (1e-3 of the "
        f"tensor's largest + 1e-3 of the model's), the worst "
        f"{cpu['grad']['name']} |d| {cpu['grad']['d']:.3g} (its largest "
        f"{cpu['grad']['scale']:.3g}, the model's {cpu['grad']['top']:.3g});"
        f" running means at "
        f"{cpu['mean_ratio']:.3g} of theirs (1e-4 of the running std), "
        f"running variances rel {cpu['var_rel']:.3g} (bar 1e-4); the step "
        f"{cpu['card_s'] * 1e3:.1f} ms on the card, {cpu['cpu_s']:.1f} s on "
        f"the CPU")

    v = check_validation(state, cfg, val, device)
    log(validation_text(tag, "the state Trainer.fit ended with", v))

    fresh = T.create_train_state(cfg, 2, device)
    step = T.make_train_step(cfg, 1, seed=0)
    tb = T.to_device(first, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for _ in range(10):
        t0 = time.perf_counter()
        losses.append(float(step(fresh, tb)["loss"]))
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"10 steps on one batch: losses {losses}")
    med = float(np.median(walls))
    split = train_split(fresh, cfg, tb)
    # after 3 updates the fit state's keys may barely differ between songs
    # (its BatchNorm statistics are still mostly the initial ones); this
    # state's must answer to the audio, so that its agreement means more
    v2 = check_validation(fresh, cfg, val, device, min_spread=0.05)
    log(f"[6 train] {tag}one batch of {cfg.batch_size * cfg.acc_grad} songs "
        f"repeated for 10 steps: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"(" + ", ".join(f"{x:.4f}" for x in losses) + "); step wall "
        f"median {med * 1e3:.1f} ms (min {min(walls) * 1e3:.1f}, max "
        f"{max(walls) * 1e3:.1f}) = {cfg.batch_size * cfg.acc_grad / med:.1f}"
        f" songs/s; peak memory {peak / 2**20:.1f} MiB "
        f"(max_memory_allocated); ({card_line()})")
    log(f"[6 train] {tag}one step on the card (torch.profiler, "
        f"train_step in IEEE float32; {split['pads_lost']} pad rows "
        f"lost): {split['total_ms']:.3f} ms "
        f"device; " + ", ".join(f"{k} {v_:.3f} ms"
                                for k, v_ in split["split"].items())
        + "; largest kernels: " + "; ".join(
            f"{k[:60]} {t:.3f} ms" for k, t in split["top"]))
    log(validation_text(tag, "the state after one batch's 11 steps", v2))

    est = KeyEstimator.from_checkpoint(run_dir, device=device)
    if est.cfg.multi_scale != cfg.multi_scale:
        raise AssertionError(f"checkpoint served as {est.cfg}")
    paths = [it["file"] for it in val.items]
    est.predict_files(paths)          # warm-up
    preds, serve_launches, serve_wall = counted(
        lambda: est.predict_files(paths, return_raw=True))
    if serve_launches != expected_launches(est) \
            or serve_launches["conv7_layer"] != per_batch:
        raise AssertionError(f"checkpoint served: launches {serve_launches}")
    best = T.create_train_state(cfg, 0, device)
    best.model.load_state_dict(torch.load(
        os.path.join(run_dir, "best_model.pt"), weights_only=True))
    own, _, _ = eval_outputs(best, cfg, val)
    served_key = torch.from_numpy(np.stack([q.key_probs for q in preds]))
    serve_d = float((served_key - own["key"]).abs().max())
    if serve_d >= 1e-3 or not torch.isfinite(served_key).all():
        raise AssertionError(f"checkpoint served: key |d| {serve_d}")
    log(f"[6 train] {tag}best checkpoint served back "
        f"(KeyEstimator.from_checkpoint, predict_files on the "
        f"{len(paths)} validation WAVs): launches A "
        f"{serve_launches['cascade_pad']} B "
        f"{serve_launches['octave_response']} C "
        f"{serve_launches['conv7_layer']}; key |d| against the trainer's "
        f"eval outputs of that state {serve_d:.3g} (bar 1e-3); e.g. "
        f"{preds[0].key!r}; wall {serve_wall * 1e3:.1f} ms")
    return {"import_launches": import_launches, "sets": (train, val),
            "first": first,
            "fit_launches": fit_launches,
            "val_launches": {k: v["launches"][k] + v2["launches"][k]
                             for k in v["launches"]},
            "serve_launches": serve_launches,
            "step_ms": med * 1e3, "peak_mib": peak / 2**20}


def mask_sums(keep: torch.Tensor) -> tuple:
    """A dropout mask's fingerprint: its shape, its count of kept
    elements and a position-weighted sum (exact in float64)."""
    w = torch.arange(keep.numel(), device=keep.device,
                     dtype=torch.float64) % 1009
    return (tuple(keep.shape), int(keep.sum()),
            float((keep.flatten().double() * w).sum()))


def remat_step(cfg: Config, batch: dict, device) -> dict:
    """One train step of cfg from create_train_state(cfg, 0) after a
    warm-up step on another state: loss, gradients, BatchNorm buffers,
    wall, peak device memory, and the fingerprint of every dropout mask
    drawn (blocks.dropout wrapped: each mask drawn again from a copy of
    the generator's state)."""
    step = T.make_train_step(cfg, 1, seed=0)
    step(T.create_train_state(cfg, 0, device), batch)
    st = T.create_train_state(cfg, 0, device)
    masks = []
    dropout = blocks.dropout

    def recording(x, rate, generator, shard=None):
        g = torch.Generator(device=x.device)
        g.set_state(generator.get_state())
        masks.append(mask_sums(torch.empty_like(x).bernoulli_(
            1.0 - rate, generator=g)))
        return dropout(x, rate, generator, shard)
    blocks.dropout = recording
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = float(step(st, batch)["loss"])
        wall = time.perf_counter() - t0
    finally:
        blocks.dropout = dropout
    return {"loss": loss, "ms": wall * 1e3,
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
            "masks": masks,
            "grads": {k: p.grad.detach().cpu() for k, p in
                      st.model.named_parameters()},
            "bufs": {k: b.detach().cpu() for k, b in
                     st.model.named_buffers() if "running" in k}}


def check_remat(name: str, cfg: Config, batch: dict, device) -> dict:
    """One train step of cfg with remat off and on, from the same seeds,
    the dropout generator on the card: remat against no remat, loss rel
    <= 1e-6, gradients within phase 6's bar, every BatchNorm running
    statistic rel <= 1e-6 (updated once: the recomputation leaves them
    alone); with dropout, each mask of the forward drawn again in the
    recomputation and the masks those of the step without remat."""
    off = remat_step(cfg.replace(remat=False), batch, device)
    on = remat_step(cfg.replace(remat=True), batch, device)
    res = {"loss_rel": abs(on["loss"] - off["loss"]) / abs(off["loss"]),
           "grad": scale_ratio(on["grads"], off["grads"], 1e-3, 1e-3),
           "bn_rel": max(float(((on["bufs"][k] - v).abs()
                                / v.abs().clamp_min(1e-30)).max())
                         for k, v in off["bufs"].items()),
           "masks": len(off["masks"]), "off": off, "on": on}
    # with remat each mask is drawn in the forward and again in the
    # recomputation: every fingerprint twice, and the set of them the
    # step's without remat
    twice = sorted(on["masks"]) == sorted(off["masks"] * 2)
    if cfg.drop > 0 and (not off["masks"] or not twice):
        raise AssertionError(f"{name}: dropout masks without remat "
                             f"{len(off['masks'])}, with remat "
                             f"{len(on['masks'])}, drawn again alike "
                             f"{twice}")
    if not (np.isfinite(on["loss"]) and res["loss_rel"] <= 1e-6
            and res["grad"]["ratio"] <= 1 and res["bn_rel"] <= 1e-6):
        raise AssertionError(f"{name}: remat vs no remat "
                             f"{ {k: res[k] for k in ('loss_rel', 'grad', 'bn_rel')} }")
    log(f"[6 train] remat {name}: one step of {batch['mel'].shape[0]} x "
        f"{batch['mel'].shape[1]} songs with remat vs without (same seeds, "
        f"dropout generator on {device}): loss {on['loss']:.6f} vs "
        f"{off['loss']:.6f} (rel {res['loss_rel']:.3g}, bar 1e-6); gradients "
        f"at {res['grad']['ratio']:.3g} of phase 6's bar (worst "
        f"{res['grad']['name']} |d| {res['grad']['d']:.3g}); BatchNorm "
        f"running statistics rel {res['bn_rel']:.3g} (bar 1e-6); "
        + (f"{len(off['masks'])} dropout masks, each drawn again alike in "
           f"the recomputation ({len(on['masks'])} with remat); "
           if cfg.drop > 0 else "no dropout; ")
        + f"step wall {on['ms']:.1f} ms with remat, {off['ms']:.1f} ms "
        f"without; peak memory {on['peak_mib']:.1f} MiB with remat, "
        f"{off['peak_mib']:.1f} MiB without ({card_line()})")
    return res


def run_remat(first: dict, device) -> dict:
    """Phase 6's remat lines: the denseblock variant with dropout 0.2 (the
    only variant with dropout) and the default model, on the first
    training batch of phase 6's corpus."""
    tb = T.to_device(first, device)
    return {name: check_remat(name, Config(fused_convstack=True, **kw), tb,
                              device)
            for name, kw in (("denseblock drop 0.2",
                              dict(denseblock=True, drop=0.2)),
                             ("default", {}))}


# ---------------------------------------------------------------------------
# phase 6b: data parallelism
# ---------------------------------------------------------------------------

DP_WORLD = 2
DP_JOIN_S = 300.0


def check_sharded(name: str, preds, ref) -> dict:
    """Sharded outputs against the unsharded kernel path on the same
    weights: key probabilities and tonic logits within rtol 2e-4, atol
    2e-5 (tests/test_predict.py:168-170), and the keys' spread across
    clips at least 0.05 (agreement's floor)."""
    res = {}
    for k in ("key_probs", "tonic_logits"):
        got = torch.from_numpy(np.stack([getattr(q, k) for q in preds]))
        want = torch.from_numpy(np.stack([getattr(q, k) for q in ref]))
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"{name}: {k} {tuple(got.shape)} vs "
                                 f"{tuple(want.shape)}")
        res[k] = check_close(f"{name}: {k}", got, want, 2e-4, 2e-5)
    key = np.stack([q.key_probs for q in ref])
    res["key_spread"] = float((key.max(0) - key.min(0)).max())
    res["names_equal"] = sum(a.key == b.key for a, b in zip(preds, ref))
    if res["key_spread"] < 0.05:
        raise AssertionError(f"{name}: the keys spread {res['key_spread']}")
    return res


def serve_sharded(paths, device) -> dict:
    """KeyEstimator(mesh=make_mesh(devices=[cuda:0, cuda:0])): two
    replicas on the one card, each batch split in two shards, each shard's
    CQT (kernels A, B) and model (kernel C) launched before any read-back.
    The default model on 16 clips and on 15 (one zero pad row of
    seq_length 1), the averaging ensemble on 16: launches twice one
    batch's (A 14 / B 2 / C 6; the ensemble 28 / 4 / 12); each shard's own
    CQTs and kernel C stacks held against their plain versions
    (hold_served); keys and tonics against the unsharded kernel path on
    the same weights (check_sharded). Then a wall clock over one sharded
    call and trace() of one sharded batch, whose trace must name the akt
    operators and the request's akx.request span."""
    mesh = make_mesh(devices=[device] * DP_WORLD)
    res = {}
    for name, kw, counts in (("default", {}, (16, 15)),
                             ("multi_scale", dict(multi_scale=True), (16,))):
        cfg = Config(fused_convstack=True, **kw)
        weights = seeded_weights(cfg)
        est = KeyEstimator(cfg, weights, device=device, mesh=mesh)
        unsharded = KeyEstimator(cfg, weights, device=device)
        for n in counts:
            clips_ = paths[:n]
            est.predict_files(clips_)          # warm-up
            unsharded.predict_files(clips_)
            preds, launches, wall, feats, stacks = served(
                est, lambda: est.predict_files(clips_, return_raw=True))
            want = {k: v * mesh.size
                    for k, v in expected_launches(unsharded).items()}
            if launches != want or len(feats) != mesh.size:
                raise AssertionError(f"sharded {name} x {n}: launches "
                                     f"{launches} in {len(feats)} shards, "
                                     f"want {want}")
            ref, _, wall_ref = counted(
                lambda: unsharded.predict_files(clips_, return_raw=True))
            agree = check_sharded(f"sharded {name} x {n}", preds, ref)
            held = hold_served(f"sharded {name} x {n}", est, feats, stacks)
            rows = sorted({tuple(b.shape) for b, _, _, _ in feats})
            del feats, stacks
            tag = f"{name} x {n}"
            res[tag] = {"launches": launches, **agree, "held": held,
                        "wall_ms": wall * 1e3,
                        "unsharded_wall_ms": wall_ref * 1e3}
            log(f"[6b dp] sharded serving {tag} clips over {mesh.size} "
                f"replicas on {device} (shards {rows}): launches A "
                f"{launches['cascade_pad']} B {launches['octave_response']} "
                f"C {launches['conv7_layer']}; against the unsharded kernel "
                f"path key |d| {agree['key_probs']:.3g}, tonic |d| "
                f"{agree['tonic_logits']:.3g} (rtol 2e-4, atol 2e-5), "
                f"{agree['names_equal']}/{n} names equal, keys spread "
                f"{agree['key_spread']:.3f}; wall {wall * 1e3:.1f} ms, "
                f"unsharded {wall_ref * 1e3:.1f} ms ({card_line()})")
            log(held_text(f"sharded {tag}", held).replace("[4 serve]",
                                                          "[6b dp]"))
        if name == "default":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            est.predict_files(paths)
            torch.cuda.synchronize()
            rate = len(paths) * CLIP_SECONDS / 60 / (time.perf_counter() - t0)
            with tempfile.TemporaryDirectory() as td:
                with trace(td):
                    est.predict_files(paths)
                text = open(os.path.join(td, "trace.json")).read()
            names = ("akt::cascade_pad", "akt::octave_response",
                     "akt::conv7", '"akx.request"')
            found = sorted(n for n in names if n in text)
            if len(found) != len(names):
                raise AssertionError(f"trace names {found} of {names}")
            res["audio_min_per_s"] = rate
            log(f"[6b dp] one sharded call of {len(paths)} clips: "
                f"{rate:.1f} audio-min/s ({rate / mesh.size:.1f} per "
                f"replica); trace() of one sharded batch: {len(text)} bytes "
                f"naming {', '.join(found)} ({card_line()})")
        del est, unsharded
        torch.cuda.empty_cache()
    return res


def fit_world1(train, val, cfg: Config, td: str, device) -> dict:
    """Trainer.fit (one epoch of one step) under a process group of world
    1 on NCCL (file:// store) against the same fit without a group: the
    same path, so the losses, the BatchNorm running statistics and the
    parameters agree within phase 6's bars, and the validation launches
    kernel C as it does without a group."""
    runs = {}
    for tag in ("world 1", "no group"):
        if tag == "world 1":
            init_data_parallel(device, init_method=f"file://{td}/world1",
                               rank=0, world_size=1)
        try:
            tr = T.Trainer(cfg, train, val, device=device)
            (state, hist), launches, wall = counted(lambda: tr.fit(seed=0))
        finally:
            if torch.distributed.is_initialized():
                torch.distributed.destroy_process_group()
        runs[tag] = {"hist": hist, "launches": launches, "wall": wall,
                     "state": {k: v.detach().cpu() for k, v in
                               state.model.state_dict().items()}}
    a, b = runs["world 1"], runs["no group"]
    # two fits on the card differ where cuDNN's backward sums in another
    # order from run to run: phase 6's bars, and 2.1 x lr for a parameter
    # whose gradient at the rounding floor flips Adam's first update
    loss_rel = max(abs(a["hist"][-1][k] - b["hist"][-1][k])
                   / abs(b["hist"][-1][k]) for k in ("train_loss",
                                                     "val_loss"))
    sa, sb = a["state"], b["state"]
    param_d = max(float((sa[k] - v).abs().max()) for k, v in sb.items()
                  if not k.endswith(("running_mean", "running_var")))
    var_rel = max(float(((sa[k] - v).abs() / v).max())
                  for k, v in sb.items() if k.endswith("running_var"))
    mean_ratio = max(float(((sa[k] - v).abs() / (1e-4 * sb[k.replace(
        "running_mean", "running_var")].sqrt())).max())
        for k, v in sb.items() if k.endswith("running_mean"))
    if not (loss_rel <= 1e-4 and param_d <= 2.1 * cfg.lr
            and var_rel <= 1e-4 and mean_ratio <= 1) \
            or a["launches"] != b["launches"] \
            or not a["launches"]["conv7_layer"]:
        raise AssertionError(f"world-1 fit vs no group: loss rel {loss_rel},"
                             f" parameters |d| {param_d}, running variances"
                             f" rel {var_rel}, means {mean_ratio}, launches "
                             f"{a['launches']} vs {b['launches']}")
    log(f"[6b dp] Trainer.fit at world 1 on NCCL: 1 epoch of 1 step "
        f"({cfg.batch_size} x {cfg.acc_grad} songs), train_loss "
        f"{a['hist'][-1]['train_loss']:.6f}, val_loss "
        f"{a['hist'][-1]['val_loss']:.6f}; against the fit without a group: "
        f"losses rel {loss_rel:.3g} (bar 1e-4), parameters |d| "
        f"{param_d:.3g} (bar 2.1 x lr), running variances rel "
        f"{var_rel:.3g} (bar 1e-4), means at {mean_ratio:.3g} of 1e-4 x "
        f"their std; validation launches C {a['launches']['conv7_layer']} "
        f"as without it; wall {a['wall']:.2f} s vs {b['wall']:.2f} s")
    return {"launches": a["launches"]}


def dp_rank(rank: int, world: int, store: str, out: str, cfg: Config,
            weights: dict, batch: dict, val) -> None:
    """One rank of the world-2 check (spawned; gloo on cuda:0, which NCCL
    refuses to share between ranks): one data-parallel train step on its
    rows of every micro-batch, a second one timed and a third under
    torch.profiler (its all-reduce rows), then evaluate(sharded=True) over
    `val` through kernel C on the step's starting weights. Writes its
    results to out/rank<rank>.pt, or its traceback to .err."""
    try:
        device = init_data_parallel("cuda", backend="gloo",
                                    init_method=f"file://{store}", rank=rank,
                                    world_size=world, local_rank=0,
                                    timeout_s=DP_JOIN_S)
        state = T.create_train_state(cfg, 0, device)
        state.model.load_state_dict(weights)
        T.data_parallel(state)
        rows = rank_rows(batch["mel"].shape[1], rank, world)
        local = T.to_device({k: np.ascontiguousarray(v[:, rows])
                             for k, v in batch.items()}, device)
        step = T.make_train_step(cfg, 1, seed=0)
        loss = T.global_losses([step(state, local)["loss"]])[0]
        res = {"loss": loss,
               "grads": {k: p.grad.detach().cpu() for k, p in
                         state.model.named_parameters()},
               "params": {k: p.detach().cpu() for k, p in
                          state.model.named_parameters()},
               "buffers": {k: b.detach().cpu() for k, b in
                           state.model.named_buffers()}}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, local)
        torch.cuda.synchronize()
        res["step_ms"] = (time.perf_counter() - t0) * 1e3
        act = torch.profiler.ProfilerActivity
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            step(state, local)
            torch.cuda.synchronize()
        res["profiled_step_ms"] = (time.perf_counter() - t0) * 1e3
        res["all_reduce"] = {
            a.key: (a.count, a.cpu_time_total / 1e3)
            for a in prof.key_averages() if "all_reduce" in a.key
            or "allreduce" in a.key}
        fresh = T.create_train_state(cfg, 0, device)
        fresh.model.load_state_dict(weights)
        res["evaluate"], res["eval_launches"], _ = counted(
            lambda: T.evaluate(T.make_eval_step(cfg), fresh, val,
                               cfg.batch_size, sharded=True))
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def spawn_world2(td: str, cfg: Config, weights: dict, batch: dict,
                 val) -> list:
    """dp_rank on DP_WORLD spawned processes; any rank that fails, exits
    non-zero or outlives DP_JOIN_S fails the run (every process is
    stopped first)."""
    import torch.multiprocessing as mp
    out = os.path.join(td, "ranks")
    os.makedirs(out)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=dp_rank, args=(
        r, DP_WORLD, os.path.join(out, "store"), out, cfg, weights, batch,
        val)) for r in range(DP_WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DP_JOIN_S
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    errs = [open(os.path.join(out, f"rank{r}.err")).read()
            for r in range(DP_WORLD)
            if os.path.exists(os.path.join(out, f"rank{r}.err"))]
    codes = [p.exitcode for p in procs]
    if hung or errs or any(codes):
        raise AssertionError(f"world-2 ranks: hung {hung}, exit codes "
                             f"{codes}\n" + "\n".join(errs))
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(DP_WORLD)]


def run_dp(waves, td: str, device, train, val) -> dict:
    """Phase 6b: sharded serving of 16 x 120 s WAVs (the 180 s bucket, T =
    901) with the profiling helpers, then training at world 1 on NCCL and
    at world 2 on gloo, on phase 6's default-width corpus."""
    t0 = time.perf_counter()
    paths = []
    for i, w in enumerate(waves):
        paths.append(os.path.join(td, f"dp_{i}.wav"))
        audio_io.write_wav(paths[-1], w, SR)
    out = {"serve": serve_sharded(paths, device),
           "fit1": fit_world1(train, val, Config(fused_convstack=True,
                                                 epochs=1), td, device),
           "world2": train_world2(train, val, Config(fused_convstack=True),
                                  td, device)}
    log(f"[6b dp] phase wall {time.perf_counter() - t0:.1f} s")
    return out


def train_world2(train, val, cfg: Config, td: str, device) -> dict:
    """The world-2 step and evaluate (dp_rank, spawned) against one
    process on the card, same weights (seeded_weights) and rows: micro
    batch 8 (4 rows a rank) x acc_grad 2. Bars: loss rtol 1e-5; running
    variances rtol 1e-6, running means within 1e-6 of the running std;
    gradients at phase 6's bar (scale_ratio 1e-3, 1e-3); parameters after
    Adam within 2.1 x lr (tests/test_train.py:108-113); every rank's
    parameters equal; evaluate's aggregates within rtol 1e-4, atol 1e-5
    (tests/test_train.py:158-160), each rank launching kernel C 3 times a
    batch."""
    cfg = cfg.replace(batch_size=8, acc_grad=2)
    weights = {k: v.cpu() for k, v in seeded_weights(cfg).items()}
    b = next(train.batches(cfg.batch_size * cfg.acc_grad, shuffle=True,
                           seed=0, drop_last=True))
    b.pop("valid")
    batch = {k: np.reshape(v, (cfg.acc_grad, cfg.batch_size) + v.shape[1:])
             for k, v in b.items()}
    t0 = time.perf_counter()
    ranks = spawn_world2(td, cfg, weights, batch, val)
    spawn_s = time.perf_counter() - t0
    single = T.create_train_state(cfg, 0, device)
    single.model.load_state_dict(weights)
    step = T.make_train_step(cfg, 1, seed=0)
    tb = T.to_device(batch, device)
    loss = float(step(single, tb)["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(T.create_train_state(cfg, 0, device), tb)   # a timed step
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) * 1e3
    want = {"grads": {k: p.grad.detach().cpu() for k, p in
                      single.model.named_parameters()},
            "params": {k: p.detach().cpu() for k, p in
                       single.model.named_parameters()},
            "buffers": {k: b_.detach().cpu() for k, b_ in
                        single.model.named_buffers()}}
    fresh = T.create_train_state(cfg, 0, device)
    fresh.model.load_state_dict(weights)
    ref_eval, ref_launches, _ = counted(lambda: T.evaluate(
        T.make_eval_step(cfg), fresh, val, cfg.batch_size))
    r0 = ranks[0]
    res = {"loss": r0["loss"], "single_loss": loss,
           "loss_rel": abs(r0["loss"] - loss) / abs(loss),
           "grad": scale_ratio(r0["grads"], want["grads"], 1e-3, 1e-3),
           "param_d": max(float((r0["params"][k] - v).abs().max())
                          for k, v in want["params"].items()),
           "var_rel": max(float(((r0["buffers"][k] - v).abs() / v).max())
                          for k, v in want["buffers"].items()
                          if k.endswith("running_var")),
           "mean_ratio": max(float(((r0["buffers"][k] - v).abs() / (
               1e-6 * want["buffers"][k.replace("running_mean",
                                                "running_var")].sqrt())
                                    ).max())
                             for k, v in want["buffers"].items()
                             if k.endswith("running_mean"))}
    same = all(torch.equal(r[part][k], v) for r in ranks[1:]
               for part in ("params", "buffers")
               for k, v in r0[part].items())
    eval_d = {k: abs(r0["evaluate"][k] - v) / max(abs(v), 1e-30)
              for k, v in ref_eval.items()}
    eval_ok = all(abs(r["evaluate"][k] - v) <= 1e-5 + 1e-4 * abs(v)
                  for r in ranks for k, v in ref_eval.items())
    n_batches = -(-len(val) // cfg.batch_size)
    per_batch = stack_launches(single.model, cfg.dtype)["conv7_layer"]
    launches_ok = all(r["eval_launches"] == ref_launches for r in ranks) \
        and ref_launches["conv7_layer"] == per_batch * n_batches
    if not (res["loss_rel"] <= 1e-5 and res["grad"]["ratio"] <= 1
            and res["param_d"] <= 2.1 * cfg.lr and res["var_rel"] <= 1e-6
            and res["mean_ratio"] <= 1 and same and eval_ok
            and launches_ok):
        raise AssertionError(f"world-2 step/evaluate against one process: "
                             f"{res}, ranks equal {same}, evaluate "
                             f"{[r['evaluate'] for r in ranks]} vs "
                             f"{ref_eval}, launches "
                             f"{[r['eval_launches'] for r in ranks]}")
    ar = r0["all_reduce"]
    log(f"[6b dp] world 2 on one card (gloo, 2 spawned ranks, "
        f"{spawn_s:.1f} s with start-up): one step of {cfg.batch_size} x "
        f"{cfg.acc_grad} songs (4 rows a rank) against one process: loss "
        f"{res['loss']:.6f} vs {loss:.6f} (rel {res['loss_rel']:.3g}, bar "
        f"1e-5); gradients at {res['grad']['ratio']:.3g} of their bar, the "
        f"worst {res['grad']['name']}; parameters after Adam |d| "
        f"{res['param_d']:.3g} (bar 2.1 x lr = {2.1 * cfg.lr:.3g}); running "
        f"variances rel {res['var_rel']:.3g} (bar 1e-6), means at "
        f"{res['mean_ratio']:.3g} of 1e-6 x their std; the ranks' "
        f"parameters equal; evaluate over {len(val)} songs "
        f"({n_batches} batches, launches a rank A "
        f"{r0['eval_launches']['cascade_pad']} B "
        f"{r0['eval_launches']['octave_response']} C "
        f"{r0['eval_launches']['conv7_layer']}, one process C "
        f"{ref_launches['conv7_layer']}) within rtol 1e-4 / "
        f"atol 1e-5, largest rel |d| "
        + ", ".join(f"{k} {v:.2g}" for k, v in sorted(
            eval_d.items(), key=lambda kv: -kv[1])[:3])
        + f"; the DP step {r0['step_ms']:.1f} ms wall, rank 0 (one process "
        f"{single_ms:.1f} ms; {r0['profiled_step_ms']:.1f} ms under "
        f"torch.profiler, all-reduce rows "
        + ", ".join(f"{k} x{n} {t:.1f} ms host" for k, (n, t) in ar.items())
        + f") ({card_line()})")
    return {"eval_launches": r0["eval_launches"], "step_ms": r0["step_ms"],
            "single_ms": single_ms}


# ---------------------------------------------------------------------------
# phase 7: the probe and experiment kernels
# ---------------------------------------------------------------------------

def check_exact(name, got, ref) -> float:
    if got.shape != ref.shape or got.dtype != ref.dtype \
            or not torch.equal(got, ref):
        err = (float((got.float() - ref.float()).abs().max())
               if got.shape == ref.shape else float("inf"))
        raise AssertionError(f"{name}: not equal to its plain version "
                             f"({tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(ref.shape)} {ref.dtype}, max |d| {err})")
    return 0.0


def check_window_copy(device) -> dict:
    """#5, six variants: 44.1 kHz 3 s B = 4 (the CPU test's geometry),
    the serving geometry (22050 Hz, 120 s, B = 16) and B = 13 at the
    serving rate (a batch no chunking divides); times at B = 16, each
    variant's card ms and the rate of the bytes it stages."""
    res = {"ms": 0.0, "card_ms": 0.0, "card_ms_100": 0.0, "plain_ms": 0.0,
           "rates": {}, "bound_ms": 0.0, "variants": {}}
    for sr, clip, batch in ((44100, 3, 4), (SR, CLIP_SECONDS, BATCH),
                            (SR, CLIP_SECONDS, 13)):
        n_fft, hop, L, tile_t, starts, length = probe_dma_rate.geometry(
            sr, clip, batch)
        win = n_fft + PC.ALIGN
        x = probe_dma_rate.make_stream(batch, L, n_fft, length, device)
        st = torch.tensor(starts, dtype=torch.int32, device=device)
        stride = PC.static_stride(hop, len(starts), win, length)
        for v in PC.WINDOW_VARIANTS:
            args = (x, st, v, tile_t, win, stride)
            check_exact(f"window_copy {v} sr={sr} B={batch}",
                        PC.window_copy(*args), PC.window_copy_plain(*args))
            if (sr, batch) != (SR, BATCH):
                continue
            ms = time_ms(lambda: PC.window_copy(*args))
            card = graph_ms(lambda: PC.window_copy(*args))
            # 100 calls in one graph (as #8's floor): the graph's own
            # launch, ~1.5 us a call at 5, spread thinner
            card100 = graph_ms(lambda: PC.window_copy(*args), repeat=100)
            res["ms"] += ms
            res["card_ms"] += card
            res["card_ms_100"] += card100
            res["plain_ms"] += time_ms(lambda: PC.window_copy_plain(*args))
            nbytes = PC.window_copy_bytes(v, len(starts), tile_t, win, batch)
            res["rates"][v] = nbytes / (ms * 1e-3) / 1e9
            # the windows the variant stages, and its output
            b = bound(nbytes + len(starts) * 4)["bound_ms"]
            res["bound_ms"] += b
            res["variants"][v] = {
                "card_ms": card, "card_ms_100": card100, "bound_ms": b,
                "bytes": nbytes, "card_GBps": nbytes / (card * 1e-3) / 1e9,
                "card_100_GBps": nbytes / (card100 * 1e-3) / 1e9}
    log("[7 probes] #5 window_copy: 6 variants x 3 geometries (B = 4, 16, "
        "13) exact; at B = 16 per variant: " + ", ".join(
            f"{v} {r['card_ms'] * 1e3:.2f} us card ({r['card_GBps']:.0f} "
            f"GB/s), {r['card_ms_100'] * 1e3:.2f} us at 100 a graph "
            f"({r['card_100_GBps']:.0f} GB/s), eager {res['rates'][v]:.0f} "
            "GB/s" for v, r in res["variants"].items())
        + f"; six variants {res['ms']:.4f} ms eager, {res['card_ms']:.4f} "
        f"ms on the card (CUDA graph, 5 a graph; "
        f"{res['card_ms_100']:.4f} at 100 a graph), bound "
        f"{res['bound_ms']:.5f} ms ({res['bound_ms'] / res['card_ms']:.1%}; "
        f"{res['bound_ms'] / res['card_ms_100']:.1%})")
    return res


def check_stages(y: torch.Tensor, p: C.CQTParams, device) -> dict:
    """#6 on all 8 octaves of the serving clips (int16 octave 0, bf16
    streams from kernel A's arena) and on a small 8 kHz geometry: load /
    realign exact; gemm and full within kernel B's 1e-4 (the raw GEMM of
    the int16 octave 0 within the int16 bar 1e-3: unnormalized PCM sums);
    full equal to the production kernel B's rows of that octave."""
    res = {"err": 0.0, "ms": {}, "card_ms": {}, "plain_ms": {},
           "bound_ms": 0.0, "ops_ms": 0.0}
    g = np.random.default_rng(4)
    small = torch.from_numpy(pcm16(g.uniform(-0.6, 0.6, (3, 16000))
                                   .astype(np.float32))).to(device)
    ps = C.CQTParams(sr=8000, hop=1600, bins_per_octave=12, octaves=3)
    for yy, pp in ((small, ps), (y, p)):
        n_fft = C.kernel_bank(pp)["n_fft"]
        B, L = yy.shape
        lay = K.arena_layout(L, pp.octaves, n_fft)
        c = K._constants(pp, 1 + L // pp.hop, 1 / 32768.0, str(device))
        x0 = C.pad_stream(yy, n_fft // 2, lay.lengths[0])
        arena = K.cascade_arena(x0, lay, n_fft // 2, 1 / 32768.0,
                                torch.bfloat16)
        prod = torch.empty(B, pp.n_bins, c.starts.shape[1], device=device)
        K.octave_response(x0, arena, lay, c.starts, c.bank, c.scales, prod)
        octs = [(buf, c.starts[o], c.bank, c.scales[o]) for o, buf in
                enumerate(K.octave_streams(x0, arena, lay))]
        for o, (buf, st, bank, sc) in enumerate(octs):
            for stage in K.STAGES:
                got = K.octave_response_stage(buf, st, bank, sc, stage)
                ref = K.octave_response_stage_plain(buf, st, bank, sc,
                                                    stage)
                name = f"stage {stage} octave {o} sr={pp.sr}"
                if stage in ("load", "realign"):
                    check_exact(name, got, ref)
                    continue
                tol = 1e-3 if (stage, o) == ("gemm", 0) else 1e-4
                res["err"] = max(res["err"],
                                 check_close(name, got, ref, tol, tol))
            row0 = (pp.octaves - 1 - o) * pp.bins_per_octave
            check_exact(f"stage full vs kernel B octave {o} sr={pp.sr}", got,
                        prod[:, row0:row0 + pp.bins_per_octave].contiguous())
    # bounds at the serving geometry: load / realign read bpo samples of
    # each window and write them; gemm reads the covered window samples
    # and the cos rows, computes bpo rows; full as kernel B on one octave;
    # the GEMMs as the TF32 products kernel B issues (tf32_products)
    bpo, T = p.bins_per_octave, c.starts.shape[1]
    for o, (buf, st, _, _) in enumerate(octs):
        item = buf.element_size()
        cover = window_cover(st.tolist(), n_fft) * B * item
        out_b = B * bpo * T * 4
        gemm = 2 * B * T * bpo * n_fft * tf32_products(buf.dtype)
        for b in (bound(B * T * bpo * item + out_b),) * 2 + (
                bound(cover + bpo * n_fft * 4 + out_b, gemm, TF32_FLOPS),
                bound(cover + 2 * n_fft * 72 * 4 + out_b, 2 * gemm,
                      TF32_FLOPS)):
            res["bound_ms"] += b["bound_ms"]
            res["ops_ms"] += b["bound_ms"] if b["bound_by"] == "operations" \
                else 0.0
    for stage in K.STAGES:
        def run(fn, stage=stage):
            return lambda: [fn(*a, stage) for a in octs]
        res["ms"][stage] = time_ms(run(K.octave_response_stage))
        res["card_ms"][stage] = graph_ms(run(K.octave_response_stage))
        res["plain_ms"][stage] = time_ms(run(K.octave_response_stage_plain))
    log("[7 probes] #6 kernel B stages, 8 octaves at serving geometry: "
        + ", ".join(f"{s} {res['ms'][s]:.4f} ms (card "
                    f"{res['card_ms'][s]:.4f}, plain "
                    f"{res['plain_ms'][s]:.4f})" for s in K.STAGES)
        + f"; max|d| gemm/full {res['err']:.3g}; full == kernel B; bound "
        f"{res['bound_ms']:.4f} ms")
    return res


def check_transpose_pad(y: torch.Tensor) -> dict:
    """#7, int16 and float32, exact against the plain version: an (8, 9001)
    batch, the serving clips, B = 256 x 120 s (the entry point's
    default), B = 40 (over 32 clips, not a multiple of 32) and the view
    y[:, 1:] (rows 2 bytes past 16-byte lines); tiny batches, where a
    clip's span is short enough that clamping its bulk copy to the
    tensor's 16-byte lines leaves the lanes' own copies most or all of it
    (views (33, 40)[:, 1:] and (1, 9)[:, 1:], every span clamped in the
    int16 one, and (13, 23) at an odd stride); a refused geometry gives
    None. Card ms at B = 16 and B = 256 (int16), each beside
    y.t().contiguous(): a transpose with no pad, not the same function."""
    g = torch.Generator(device=y.device).manual_seed(7)
    wide = torch.randint(-32768, 32767, (256, y.shape[1]), generator=g,
                         dtype=torch.int16, device=y.device)
    small = y[:8, :9001].contiguous()
    for yy in (small, y, wide, wide[:40], y[:, 1:]):
        for cast in (yy, yy.float()):
            L = cast.shape[1]
            got = PC.transpose_pad_tm(cast, (L // 4410) * 4410, 512)
            lfull = PC.transpose_pad_geometry(cast, (L // 4410) * 4410, 512)
            check_exact(f"transpose_pad {cast.dtype} {tuple(cast.shape)} "
                        f"stride {cast.stride(0)}", got,
                        PC.transpose_pad_plain(cast, 256, lfull))
            del got
    # (shape, leading samples cut, half, zero rows)
    for shape, cut, half, zeros in (((33, 40), 1, 16, 24), ((1, 9), 1, 4, 7),
                                    ((13, 23), 0, 8, 5)):
        base = torch.randint(-32768, 32767, shape, generator=g,
                             dtype=torch.int16, device=y.device)
        for full in (base, base.float()):
            cast = full[:, cut:]
            lfull = 2 * half + cast.shape[1] + 1 + zeros
            check_exact(f"transpose_pad {cast.dtype} {tuple(full.shape)}"
                        f"[:, {cut}:] half {half}",
                        PC.transpose_pad(cast, half, lfull),
                        PC.transpose_pad_plain(cast, half, lfull))
    if PC.transpose_pad_tm(y[:, :2000], 0, 512) is not None:
        raise AssertionError("transpose_pad_tm accepted a refused geometry")
    res = {}
    for key, yy in (("", y), ("b256_", wide)):
        lfull = PC.transpose_pad_geometry(yy, (yy.shape[1] // 4410) * 4410,
                                          512)
        b = bound((yy.shape[1] + lfull) * yy.shape[0] * yy.element_size())
        res[key + "bound_ms"], res[key + "bound_by"] = b["bound_ms"], \
            b["bound_by"]
        res[key + "ms"] = time_ms(lambda: PC.transpose_pad(yy, 256, lfull))
        res[key + "card_ms"] = graph_ms(
            lambda: PC.transpose_pad(yy, 256, lfull))
        res[key + "plain_ms"] = time_ms(
            lambda: PC.transpose_pad_plain(yy, 256, lfull))
        res[key + "transpose_only_card_ms"] = graph_ms(
            lambda: yy.t().contiguous())
    del wide
    log(f"[7 probes] #7 transpose_pad: int16 and f32 exact at (8, 9001), "
        f"(16, {y.shape[1]}), (256, {y.shape[1]}), (40, {y.shape[1]}), "
        f"the view y[:, 1:] and the tiny (33, 40)[:, 1:], (1, 9)[:, 1:] and "
        f"(13, 23); int16 B = 16: {res['ms']:.4f} ms eager, "
        f"{res['card_ms']:.4f} ms on the card (bound {res['bound_ms']:.5f} "
        f"ms, {res['bound_ms'] / res['card_ms']:.1%}), plain "
        f"{res['plain_ms']:.4f} ms; B = 256: {res['b256_ms']:.4f} ms "
        f"eager, {res['b256_card_ms']:.4f} ms on the card "
        f"(bound {res['b256_bound_ms']:.5f} ms, "
        f"{res['b256_bound_ms'] / res['b256_card_ms']:.1%}), plain "
        f"{res['b256_plain_ms']:.4f} ms; "
        f"y.t().contiguous() (transpose only, no pad: not the same "
        f"function) {res['transpose_only_card_ms']:.4f} / "
        f"{res['b256_transpose_only_card_ms']:.4f} ms on the card")
    return res


def check_launch_and_primitives(device) -> dict:
    """#8 at grid 1 / 25 / 201, and 100 launches at grid 201 captured in
    a CUDA graph whose replay must write the ones; the six #9 probes.
    All exact."""
    x = torch.zeros(1 << 12, 512, dtype=torch.int16, device=device)
    for grid_n in (1, 25, 201):
        check_exact(f"launch_probe grid {grid_n}",
                    PC.launch_probe(x, grid_n),
                    PC.launch_probe_plain(x, grid_n))
    ref = PC.launch_probe_plain(x, 201)
    replay, outs = PC.launch_graph(x, 201, probe_pallas_overhead.BURST)
    for o in outs:
        o.zero_()
    replay()
    torch.cuda.synchronize()
    for i, o in enumerate(outs):
        check_exact(f"launch_probe graph replay, launch {i}", o, ref)
    res = {"launch_ms": time_ms(lambda: PC.launch_probe(x, 201)),
           "launch_plain_ms": time_ms(lambda: PC.launch_probe_plain(x, 201)),
           "graph_ms": time_ms(replay) / len(outs),
           # torch.ones, #8's plain version, replayed from a CUDA graph
           "ones_card_ms": graph_ms(lambda: PC.launch_probe_plain(x, 201)),
           "launch_bound": bound(201 * 8 * 128 * 4),
           "prim_ms": 0.0, "prim_card_ms": 0.0, "prim_plain_ms": 0.0,
           "prim_bound_ms": 0.0}
    del replay, outs
    for name in PC.PRIMITIVES:
        xi = PC.primitive_input(name).to(device)
        check_exact(f"primitive {name}", PC.primitive(name, xi),
                    PC.primitive_plain(name, xi))
        res["prim_ms"] += time_ms(lambda: PC.primitive(name, xi))
        res["prim_card_ms"] += graph_ms(lambda: PC.primitive(name, xi))
        res["prim_plain_ms"] += time_ms(lambda: PC.primitive_plain(name, xi))
        shape, _, out_shape = PC.PRIMITIVES[name]
        res["prim_bound_ms"] += bound(
            xi.numel() * xi.element_size()
            + int(np.prod(out_shape)) * 4)["bound_ms"]
    log(f"[7 probes] #8 launch_probe grid 201: {res['launch_ms']:.4f} ms vs "
        f"plain {res['launch_plain_ms']:.4f} ms; CUDA graph of "
        f"{probe_pallas_overhead.BURST} launches replayed exactly, "
        f"{res['graph_ms']:.5f} ms per launch (torch.ones "
        f"{res['ones_card_ms']:.5f} ms on the card); #9 six primitives "
        f"exact, {res['prim_ms']:.4f} ms eager, {res['prim_card_ms']:.4f} ms "
        f"on the card, vs plain {res['prim_plain_ms']:.4f} ms")
    return res


PROBE_COUNTERS = (PC.window_copy, K.octave_response_stage, PC.transpose_pad,
                  PC.launch_probe, PC.primitive)


def drive_probes() -> dict:
    """Each probe entry point once at the serving geometry (22050 Hz,
    hop 4410, B = 16, 120 s; the launch probe at its smallest input),
    with the probe kernels' launch counts read around the run."""
    for fn in PROBE_COUNTERS:
        fn.launches = 0
    errs = probe_pallas_primitives.main()
    floor = probe_pallas_overhead.main(sizes=probe_pallas_overhead.SIZES[:1])
    probe_dma_rate.main(sr=SR, clip=CLIP_SECONDS, batch=BATCH)
    for octave in (0, 1):
        probe_cqt_kernel_stages.main(sr=SR, clip=CLIP_SECONDS, batch=BATCH,
                                     octave=octave)
    experiment_transpose_kernel.main(batch=BATCH)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in PROBE_COUNTERS}
    if any(e != 0.0 for e in errs.values()):
        raise AssertionError(f"probe_pallas_primitives FAIL: {errs}")
    if not all(launches.values()):
        raise AssertionError(f"a probe entry point ran no kernel: {launches}")
    log(f"[7 probes] entry points driven; launches {launches}")
    log("[7 probes] #8 per launch (ms): " + ", ".join(
        f"{k} {v:.5f}" for k, v in floor.items()
        if isinstance(k, str) and k.startswith("burst")))
    log("[7 probes] #8 host per call (us, one process): " + ", ".join(
        f"{k[6:]} {v:.3f}" for k, v in floor.items()
        if isinstance(k, str) and k.startswith("host, ")))
    return launches


# ---------------------------------------------------------------------------
# phase 7b: the port's bench
# ---------------------------------------------------------------------------

LOOP_BATCH = 12                 # does not divide the 16-file corpus
BENCH_ARGS = ("--batches", "256", "--loop_batches", str(LOOP_BATCH),
              "--loop_rows", "2400")
BENCH_TIMEOUT_S = 300
BENCH_LAUNCHES = {"cascade_pad": 7, "octave_response": 1, "conv7_layer": 3}
LOOP_RTOL = 1e-5


def check_bench(rep: dict) -> None:
    """The bench's report against what its run must show (phase 7b)."""
    if "error" in rep:
        raise AssertionError(f"bench error: {rep['error']}")
    for dtype, cells in rep["fronts"]["kernels"].items():
        for name, cell in cells.items():
            if "error" in cell:
                raise AssertionError(f"bench kernels {dtype} {name}: "
                                     f"{cell['error']}")
            for k, want in BENCH_LAUNCHES.items():
                got = cell["launches_per_call"][k]
                if any(c != want for c in got):
                    raise AssertionError(
                        f"bench kernels {dtype} {name}: {k} launched {got} "
                        f"times per call, expected {want}")
    if not rep["value"] > 0:
        raise AssertionError(f"bench value {rep['value']}")
    if not 0 < rep["mfu"] <= 1:
        raise AssertionError(f"bench mfu {rep['mfu']} outside (0, 1]")
    if (rep["front_end"], rep["dtype"]) != ("kernels", "float32"):
        raise AssertionError(f"bench headline {rep['front_end']} "
                             f"{rep['dtype']}, expected kernels float32")
    for name, loop in rep["end_to_end"].items():
        # step i reads the files of serial step i mod len(serial)
        ref, checks = loop["serial"]["loop_sums"], loop["serial"]["input_sums"]
        off = [(i, c) for i, c in enumerate(loop["input_sums"])
               if c != checks[i % len(checks)]]
        if off:
            raise AssertionError(
                f"bench loop {name}: steps {off[:8]} copied other samples "
                f"to the card than the same steps run alone {checks}: a "
                f"buffer rewritten under its copy")
        off = [(i, s) for i, s in enumerate(loop["loop_sums"])
               if abs(s - ref[i % len(ref)]) > LOOP_RTOL
               * abs(ref[i % len(ref)])]
        if off:
            raise AssertionError(
                f"bench loop {name}: steps {off[:8]} differ from the same "
                f"steps run alone {ref} beyond rtol {LOOP_RTOL}")
        # the producer ingests every step inside the timed window, one
        # after the other, and so does the consumer run its steps
        if loop["audio_min_per_s"] > loop["ingest_audio_min_per_s"]:
            raise AssertionError(
                f"bench loop {name}: {loop['audio_min_per_s']:.1f} "
                f"audio-min/s end to end beats its own ingest, "
                f"{loop['ingest_audio_min_per_s']:.1f}")
        if loop["step_s"] > loop["wall_s"]:
            raise AssertionError(
                f"bench loop {name}: steps took {loop['step_s']:.3f} s "
                f"in a {loop['wall_s']:.3f} s wall")


def run_bench() -> dict:
    """The bench as a user runs it, in its own process from the checkout's
    root, at B = 256 and a loop of 12 clips x 200 steps; its stderr lines
    and its final JSON report printed, the report checked."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "audio_key_estimation_torch.bench",
         *BENCH_ARGS], capture_output=True, text=True,
        timeout=BENCH_TIMEOUT_S,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        log(f"[7b bench]   {line}")
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"bench exited {proc.returncode} with no "
                             f"report")
    log(f"[7b bench] report: {lines[-1]}")
    rep = json.loads(lines[-1])
    check_bench(rep)
    cell = rep["fronts"]["kernels"]["float32"][f"b{rep['batch_clips']}"]
    loop = rep["end_to_end"][f"b{LOOP_BATCH}"]
    log(f"[7b bench] {' '.join(BENCH_ARGS)}: {wall:.1f} s; headline kernels "
        f"float32 B = {rep['batch_clips']}: {rep['value']:.1f} audio-min/s "
        f"({cell['pipeline_ms']:.2f} ms a call, launches "
        f"{ {k: v[0] for k, v in cell['launches_per_call'].items()} }); "
        f"loop of {LOOP_BATCH} x {loop['steps']}: "
        f"{loop['audio_min_per_s']:.1f} audio-min/s (its ingest "
        f"{loop['ingest_audio_min_per_s']:.1f}, steps {loop['step_s']:.2f} "
        f"of {loop['wall_s']:.2f} s; min(decode, pipeline) "
        f"{rep['end_to_end_min_of_stages']:.1f}), sums equal to "
        f"{len(loop['serial']['loop_sums'])} serial steps; mfu "
        f"{rep['mfu']:.4f} of {rep['mfu_peak']['flops_per_s']:.3g} "
        f"({rep['mfu_peak']['dtype']}); vs_baseline "
        f"{rep['vs_baseline']:.1f}")
    return rep


# ---------------------------------------------------------------------------
# phase 8: convergence on the hard benchmark's global corpus
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def launches_per_call(calls: dict):
    """Record the kernels' launches per call: each KeyDataset CQT
    (`calls["cqt"]`, A and B), each train step and each eval step
    (`calls["train"]`, `calls["eval"]`, A, B and C), by wrapping
    KeyDataset._features and the trainer's step factories."""
    features = KeyDataset._features
    make_train, make_eval = T.make_train_step, T.make_eval_step

    def delta(key, fn, counters):
        def run(*a, **kw):
            before = [c.launches for c in counters]
            out = fn(*a, **kw)
            calls[key].append([c.launches - b for c, b in
                               zip(counters, before)])
            return out
        return run

    def train_step(*a, **kw):
        return delta("train", make_train(*a, **kw), COUNTERS)

    def eval_step(cfg):
        step = delta("eval", make_eval(cfg), COUNTERS)
        step.cfg = cfg
        return step

    KeyDataset._features = delta("cqt", features, DATASET_COUNTERS)
    T.make_train_step, T.make_eval_step = train_step, eval_step
    try:
        yield calls
    finally:
        KeyDataset._features = features
        T.make_train_step, T.make_eval_step = make_train, make_eval


def run_converge(device) -> dict:
    """The hard benchmark's global phase as `python -m
    audio_key_estimation_torch.scripts.train_converge_hard global` runs
    it (train_converge_hard.run_phase, float32, no option changed): 240
    training and 48 validation polyphonic songs of 60 s over all 24 keys
    (disjoint timbres) rendered by a process pool (data/render_pool.py,
    in an interpreter of its own, so no worker imports this script),
    imported through
    kernels A and B (A 7, B 1 per group of 16), the default Config's
    widths at batch 16 for up to 30 epochs after the epoch -1
    evaluation, kernel C 3 times per validation batch and never in a
    train step; the report written into a temporary directory. Fails
    unless the untrained val MIREX is below 0.2 and the best reaches 0.9
    (the JAX script's bars) and the report parses back to the history.
    The pilot (48 + 24 songs of 30 s) is not used: at fit seed 0 its
    best stays under 0.9 (`train_converge_hard global --pilot --seed S`
    over seeds, PERF.md)."""
    calls = {"cqt": [], "train": [], "eval": []}
    with tempfile.TemporaryDirectory() as td, launches_per_call(calls):
        r, launches, wall = counted(lambda: train_converge_hard.run_phase(
            "global", device=device, corpus_root=os.path.join(td, "corpus"),
            out_dir=os.path.join(td, "out"), dtype="float32",
            loc_window_size=10))
        rows = train_converge_hard.parse_report(r["report"])
    hist, cfg = r["history"], r["cfg"]
    groups = -(-r["train"] // 16) + -(-r["val"] // 16)
    val_batches = -(-r["val"] // cfg.batch_size)
    steps = (len(hist) - 1) * (r["train"] // cfg.batch_size)
    want = {"cqt": [[cfg.octaves - 1, 1]] * groups,
            "eval": [[0, 0, 3, 0]] * (val_batches * len(hist)),
            "train": [[0, 0, 0, 0]] * steps}
    if (r["train"], r["val"]) != (240, 48) or calls != want:
        raise AssertionError(f"converge: {r['train']} + {r['val']} songs, "
                             f"launches per call {calls} (want {want})")
    if len(rows) != len(hist) or any(
            row["epoch"] != h["epoch"]
            or abs(row["val_mirex"] - h["val_mirex"]) > 5e-5
            or abs(row["val_loss"] - h["val_loss"]) > 5e-5
            for row, h in zip(rows, hist)):
        raise AssertionError(f"converge: report {rows} against {hist}")
    log(f"[8 converge] global ({r['train']} + {r['val']} songs of 60 s, "
        f"default widths, batch {cfg.batch_size}, {len(hist) - 1} "
        f"epochs): val MIREX by epoch "
        + ", ".join(f"{h['epoch']}: {h['val_mirex']:.4f}" for h in hist)
        + f"; untrained {r['ep0']:.4f} (bar < 0.2), best {r['best']:.4f} "
        f"(bar >= 0.9); corpus render {r['gen_s']:.1f} s, preprocess "
        f"{r['prep_s']:.1f} s, fit {r['fit_s']:.1f} s, phase {wall:.1f} s; "
        f"launches A {launches['cascade_pad']} B "
        f"{launches['octave_response']} ({groups} import groups, A 7 B 1 "
        f"each) C {launches['conv7_layer']} ({val_batches} validation "
        f"batches x {len(hist)} evaluations, 3 each; {steps} train steps, "
        f"0 each); report parses back ({len(rows)} rows); ({card_line()})")
    if not (r["ep0"] < 0.2 and r["best"] >= 0.9):
        raise AssertionError(f"converge: untrained val MIREX {r['ep0']}, "
                             f"best {r['best']} (bars < 0.2, >= 0.9)")
    return {"launches": launches, "history": hist, "wall": wall}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    device = torch.device("cuda")
    card = card_line()
    flag_log = logging.getLogger(precision.__name__)
    flag_log.setLevel(logging.INFO)
    flag_log.addHandler(FlagLog())
    log(f"[1 device] torch {torch.__version__} (CUDA {torch.version.cuda}) "
        f"on {torch.cuda.get_device_name(0)}; nvidia-smi: {card}")

    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    log(f"[2 build] {so.name} in {time.perf_counter() - t0:.1f} s")
    ops = _build.registered_ops()
    for schema in ops:
        log(f"[2 build]   {schema}")
    if len(ops) != 9:
        raise AssertionError(f"expected 9 akt operators, found {len(ops)}")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            log(f"[2 build]   {line.strip()}")
    t0 = time.perf_counter()
    host = binding.build()
    binding.load_library()
    log(f"[2 build] host audio library {host.name} in "
        f"{time.perf_counter() - t0:.1f} s (c++ {' '.join(binding.CXX_FLAGS)}"
        f", native/akx_native.cpp + akx_mp3.cpp)")

    waves = clips()
    y = torch.from_numpy(np.stack([pcm16(w) for w in waves])).to(device)
    p = C.CQTParams(sr=SR, hop=C.reference_hop(SR, Config().frames))
    res = check_cqt_kernels(y, p)
    res.update(check_conv_kernel(device))
    res.update(check_res_kernel(device))
    del y
    check_edge_geometries(device)
    oracle = run_oracle(waves, device)

    with tempfile.TemporaryDirectory() as td:
        paths = []
        for i, w in enumerate(waves):
            paths.append(os.path.join(td, f"smoke_{i}.wav"))
            audio_io.write_wav(paths[-1], w, SR)
        srv = serve_variants(paths, device)
        local = serve_local(paths, device)
        local_ms = serve_local(paths, device, "multi_scale",
                               multi_scale=True)
        mixed = serve_mixed(waves, td, device)
    batches = run_batches(device)
    with tempfile.TemporaryDirectory() as td:
        data = run_dataset(td, device)
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        roots = build_train_corpora(td)
        log(f"[6 train] corpora written with data/synthetic.py in "
            f"{time.perf_counter() - t0:.1f} s: {TRAIN_SONGS} training and "
            f"{VAL_SONGS} validation songs, {CLIP_SECONDS} s PCM16 at {SR} "
            f"Hz (scale walks)")
        trained = run_train(roots, os.path.join(td, "default"), device,
                            Config(fused_convstack=True, epochs=3))
        run_remat(trained["first"], device)
        run_precision(waves, trained["first"], trained["sets"][1], device)
        trained_ms = run_train(roots, os.path.join(td, "multi_scale"),
                               device, Config(fused_convstack=True, epochs=3,
                                              multi_scale=True),
                               tag="multi_scale: ")
        dp = run_dp(waves, td, device, *trained.pop("sets"))
        trained_ms.pop("sets")

    y = torch.from_numpy(np.stack([pcm16(w) for w in waves])).to(device)
    probe = {"window": check_window_copy(device),
             "stages": check_stages(y, p, device),
             "transpose": check_transpose_pad(y),
             "small": check_launch_and_primitives(device)}
    del y
    m = drive_probes()
    bench = run_bench()
    converge = run_converge(device)

    src = "audio_key_estimation_torch/csrc/"
    tpu = "audio_key_estimation_tpu/ops/"
    n = srv["default"]["launches"]
    served_by = {f"variant {v}": r for v, r in srv.items()} | {
        "local": local, "local multi_scale": local_ms,
        "mixed encodings": mixed}
    # each path's count of a kernel: the variants, local mode, the
    # mixed-encoding batch, and the dataset phase (its three groups, the
    # window_size songs, the cache reread)
    by_path = {k: {p: r["launches"][k] for p, r in served_by.items()}
               for k in n}
    for k in data["launches"]:
        by_path[k] |= {"dataset": data["launches"][k],
                       "dataset frames=0": data["window_launches"][k],
                       "dataset cache reread": data["cache_launches"][k],
                       "train import": trained["import_launches"][k],
                       "train multi_scale import":
                           trained_ms["import_launches"][k]}
    # the training phase: Trainer.fit (train steps and every validation),
    # the kernel C validation check, the checkpoint served back
    for k in n:
        for t, r in (("train", trained), ("train multi_scale", trained_ms)):
            by_path[k] |= {f"{t} fit": r["fit_launches"][k],
                           f"{t} validation": r["val_launches"][k],
                           f"{t} checkpoint served": r["serve_launches"][k]}
        # phase 6b: sharded serving (two replicas), the world-1 fit and
        # each world-2 rank's sharded evaluate
        by_path[k] |= {f"sharded {tag}": r["launches"][k]
                       for tag, r in dp["serve"].items() if tag != "audio_min_per_s"}
        by_path[k] |= {"dp world-1 fit": dp["fit1"]["launches"][k],
                       "dp world-2 evaluate, each rank":
                           dp["world2"]["eval_launches"][k]}
        # phase 4b: one served batch of each size and bucket
        by_path[k] |= {f"batch {name}": r["launches"][k]
                       for name, r in batches.items()}
        # phase 7b: each call of the bench's headline cell (bench.py
        # counts kernels A, B and C)
        per_call = bench["fronts"]["kernels"]["float32"]["b256"][
            "launches_per_call"]
        if k in per_call:
            by_path[k]["bench, a call (kernels float32 B 256)"] = \
                per_call[k][0]
        # phase 8: the global phase's import, train steps and validations
        by_path[k]["converge"] = converge["launches"][k]
        # phase 3o: each served CQT held against an oracle, and the default
        # model's served batch held against the reference pipeline
        by_path[k] |= {
            "oracle (a)-(c), 14 served CQTs": sum(
                r[k] for case, r in oracle["launches"].items()
                if not case.startswith("(d)")),
            "oracle (d) served batch": oracle["launches"]["(d) e2e served"][k]}
    # the largest |d| of the served batches' own CQT and kernel C stacks
    # against their plain versions, over every served path, shards too
    held = [r["held"] for r in served_by.values()] + [
        r["held"] for tag, r in dp["serve"].items() if tag != "audio_min_per_s"]
    served_cqt_d = max(h["cqt_d"] for h in held)
    served_c_d = max(h["c_d"] for h in held)
    st, sm, tp = probe["stages"], probe["small"], probe["transpose"]

    def row(name, source, replaces, launches, err, ms, plain_ms, b,
            library_ms, **extra):
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                "library_ms": library_ms, **extra}

    def by_batch(kernel):
        # phase 4b: card ms and bound at each served batch's B and bucket
        return {name: r["kernels"][kernel] for name, r in batches.items()}

    def res_bound(key):
        return {"bound_ms": res[key + "_bound_ms"],
                "bound_by": res[key + "_bound_by"]}

    # ms, plain_ms and library_ms: one eager call each (CUDA events);
    # card_ms: the kernel's launches replayed from a CUDA graph
    kernels = [
        row("cqt_decimate (kernel A, 7 octave steps)", "cqt_decimate.cu",
            tpu + "cqt_pallas.py:472", n["cascade_pad"], res["A"],
            res["A_ms"], res["A_plain_ms"], res_bound("A"),
            res["A_library_ms"], card_ms=res["A_card_ms"],
            library="F.conv1d stride 2 x 7, zero-padded interiors, IEEE "
                    "float32 (TF32 off, scoped to phase 3)",
            launches_by_path=by_path["cascade_pad"],
            served_cqt_max_abs_err=served_cqt_d,
            dataset_max_abs_err=data["mel_d"],
            by_batch=by_batch("A")),
        row("cqt_response (kernel B, 8 octaves in one launch)",
            "cqt_response.cu",
            tpu + "cqt_pallas.py:163, " + tpu + "cqt_pallas.py:316",
            n["octave_response"], res["B"], res["B_ms"], res["B_plain_ms"],
            res_bound("B"), None, gemm_only_ms=res["B_gemm_only_ms"],
            card_ms=res["B_card_ms"],
            library="none (GEMM only: torch.matmul f32, IEEE float32 "
                    "(TF32 off, scoped to phase 3), pre-gathered frames)",
            launches_by_path=by_path["octave_response"],
            served_cqt_max_abs_err=served_cqt_d,
            dataset_max_abs_err=data["mel_d"],
            by_batch=by_batch("B")),
        row("conv7 (kernel C, 3 layers: fused_convstack, f32 NCHW in and "
            "out)", "conv7.cu",
            tpu + "convstack_pallas.py:91", n["conv7_layer"], res["C"],
            res["C_ms"], res["C_plain_ms"], res_bound("C"),
            res["C_library_ms"], card_ms=res["C_card_ms"],
            library=f"F.conv2d bf16 x 3, 8 channels, cudnn.benchmark, "
                    f"{res['C_library_fmt']}, no leaky ReLU",
            library_fmts_ms=res["C_library_fmts"],
            library_old_ms=res["C_library_old_ms"],
            l1_card_ms=res["C_l1_card_ms"],
            l1_bound_ms=res["C_l1_bound_ms"],
            mid_card_ms=res["C_mid_card_ms"],
            mid_bound_ms=res["C_mid_bound_ms"],
            l3_card_ms=res["C_l3_card_ms"],
            l3_bound_ms=res["C_l3_bound_ms"],
            t901_card_ms=res["C_901_card_ms"],
            t901_bound_ms=res["C_901_bound_ms"],
            model_stage_ms=srv["default"]["split"]["total_ms"],
            model_stage_conv7_ms=srv["default"]["split"]["conv7_ms"],
            launches_by_path=by_path["conv7_layer"],
            served_max_abs_err=served_c_d, by_batch=by_batch("C")),
        row("resconv7 (the residual Pitch2Pitch stack, 7 launches: stem "
            "5->8, 3 x (8->16, 16->8 + skip); ms, plain and library summed "
            "over a stack at (256, 288, 901))", "resconv7.cu",
            "none: XLA conv in the JAX package",
            by_path["resconv7"]["variant resblock"],
            res["R"], res["R_ms"], res["R_plain_ms"],
            {"bound_ms": res["R_bound_ms"], "bound_by": "operations"},
            res["R_library_ms"], card_ms=res["R_card_ms"],
            library="F.conv2d f32 (IEEE) on the circularly pre-padded "
                    "input, the conv alone, 7 calls",
            convs=res["R_convs"], launches_by_path=by_path["resconv7"],
            served_max_rel_err=max(h["r_rel"] for h in held)),
        row("window_copy (#5, six variants; ms summed)",
            "probe_window_copy.cu", "scripts/probe_dma_rate.py:57",
            m["window_copy"], 0.0, probe["window"]["ms"],
            probe["window"]["plain_ms"],
            {"bound_ms": probe["window"]["bound_ms"], "bound_by": "bytes"},
            None, card_ms=probe["window"]["card_ms"],
            card_ms_100=probe["window"]["card_ms_100"],
            variants=probe["window"]["variants"]),
        row("cqt_response stages (#6, load/realign/gemm/full, 8 octaves; "
            "ms summed)", "cqt_response.cu",
            "scripts/probe_cqt_kernel_stages.py:59",
            m["octave_response_stage"], st["err"], sum(st["ms"].values()),
            sum(st["plain_ms"].values()),
            {"bound_ms": st["bound_ms"],
             "bound_by": "operations" if 2 * st["ops_ms"] > st["bound_ms"]
             else "bytes"}, None, card_ms=sum(st["card_ms"].values())),
        row("transpose_pad (#7, int16 B = 16)", "transpose_pad.cu",
            "scripts/experiment_transpose_kernel.py:82", m["transpose_pad"],
            0.0, tp["ms"], tp["plain_ms"], tp, None, card_ms=tp["card_ms"],
            b256_ms=tp["b256_ms"], b256_card_ms=tp["b256_card_ms"],
            b256_plain_ms=tp["b256_plain_ms"],
            b256_bound_ms=tp["b256_bound_ms"],
            transpose_only_card_ms=tp["transpose_only_card_ms"],
            b256_transpose_only_card_ms=tp["b256_transpose_only_card_ms"],
            transpose_only="y.t().contiguous(): transpose only, no pad; "
                           "not the same function"),
        row("launch_probe (#8, grid 201)", "probe_launch.cu",
            "scripts/probe_pallas_overhead.py:50", m["launch_probe"], 0.0,
            sm["launch_ms"], sm["launch_plain_ms"], sm["launch_bound"],
            sm["launch_plain_ms"], library="torch.ones (the plain version)",
            card_ms=sm["graph_ms"], library_card_ms=sm["ones_card_ms"]),
        row("primitives (#9, six probes; ms summed)", "probe_primitives.cu",
            "scripts/probe_pallas_primitives.py:42-151", m["primitive"], 0.0,
            sm["prim_ms"], sm["prim_plain_ms"],
            {"bound_ms": sm["prim_bound_ms"], "bound_by": "bytes"}, None,
            card_ms=sm["prim_card_ms"]),
    ]
    for k in kernels:
        card = (f", card {k['card_ms']:.4f} ms "
                f"({k['bound_ms'] / k['card_ms']:.1%})" if "card_ms" in k
                else "")
        log(f"[9 result] {k['name']}: {k['ms']:.4f} ms eager, bound "
            f"{k['bound_ms']:.4f} ms ({k['bound_by']}, "
            f"{k['bound_ms'] / k['ms']:.1%}){card}, plain "
            f"{k['plain_ms']:.4f} ms, library {k['library_ms']}")
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
