"""Equivariance test CLI (reference equivariance_test.py), on the CUDA
card.

    python -m audio_key_estimation_torch.cli.equivariance [--custom_cqt]
        [--wav path.wav] [--save out.npy] [--heatmap out.png] [--device cpu]

Runs an untrained PitchClassNet (weights from torch.Generator seed
--seed) on a CQT shifted by -12..+12 semitones (3 rows each at 36
bins/octave) with a ±1-octave zero guard band
(equivariance_test.py:174-205), stacks the 25x12 key outputs and checks
circular-shift equivariance programmatically (max deviation below
--atol). --wav computes the CQT of a file through the port's decode and
CQT (kernels A and B on a card, float32 streams). Without CUDA it raises
unless --device cpu.
"""

from __future__ import annotations

import argparse
from typing import Mapping, Optional

import numpy as np
import torch

from ..config import add_config_args, config_from_args
from ..data.audio_io import decode_audio
from ..data.synthetic import custom_cqt
from ..models import build_model
from ..models.convert import load_state_dict
from ..ops.cqt import CQTParams, reference_hop
from ..ops.frontend import compute_cqt, use_cuda_kernels
from ..train.trainer import resolve_device
from ..utils.precision import ieee_float32
from .train import add_device_arg

# row i of the stack: shift +12 .. -12 semitones
SHIFTS = list(range(12, -13, -1))


def shift_rows(mel: np.ndarray, semitones: int) -> np.ndarray:
    """Shift CQT rows up by `semitones` (3 rows each), zero-filling — the
    intent of mel_shifting_up/down (equivariance_test.py:122-146)."""
    steps = 3 * semitones
    out = np.zeros_like(mel)
    if steps > 0:
        out[steps:] = mel[:-steps]
    elif steps < 0:
        out[:steps] = mel[-steps:]
    else:
        out = mel.copy()
    return out


def shift_and_stack(cfg, mel: np.ndarray, seed: int = 0,
                    state_dict: Optional[Mapping] = None,
                    device="cuda") -> np.ndarray:
    """25 x 12 key outputs for shifts +12..-12 (row 0 = +12, row 24 =
    -12; equivariance_test.py:179-205), all shifts in one eval-mode
    batch. The model's weights come from torch.Generator seed `seed`, or
    from `state_dict` (e.g. models.convert.state_dict_from_jax of the JAX
    model's variables) for a model with the guard-banded octave count."""
    device = resolve_device(device)
    # pad one octave of zeros top+bottom (the guard band)
    guard = np.zeros((36, mel.shape[1]), mel.dtype)
    mel = np.concatenate([guard, mel, guard], axis=0)
    # one PitchClassNet on the 36-bin CQT, whatever multi_scale says: the
    # JAX CLI builds PitchClassNet(cfg), which has no second tower
    cfg = cfg.replace(octaves=mel.shape[0] // 36, multi_scale=False)
    model = build_model(cfg, generator=torch.Generator().manual_seed(seed))
    if state_dict is not None:
        load_state_dict(model, state_dict)
    model.to(device).eval()
    x = np.stack([shift_rows(mel, s) for s in SHIFTS])[..., None]
    with torch.inference_mode(), ieee_float32("equivariance"):
        key = model(torch.from_numpy(x).float().to(device))[0]
    return key.cpu().numpy()  # (25, 12)


def check_equivariance(stack: np.ndarray, atol: float = 1e-4) -> float:
    """Max deviation after reverse-rotating row for shift s by s."""
    base = stack[12]  # shift 0
    worst = 0.0
    for i, s in enumerate(SHIFTS):
        aligned = np.roll(stack[i], -s)
        worst = max(worst, float(np.abs(aligned - base).max()))
    return worst


def wav_cqt(path: str, cfg, device) -> np.ndarray:
    """(octaves - 2) * 36 rows of the file's log1p-CQT at the reference
    hop, float32 streams."""
    samples, sr = decode_audio(path)
    p = CQTParams(sr=sr, hop=reference_hop(sr, cfg.frames, cfg.window_size,
                                           len(samples)),
                  bins_per_octave=36, octaves=cfg.octaves - 2)
    y = torch.from_numpy(np.asarray(samples, np.float32))[None].to(device)
    with torch.inference_mode(), ieee_float32("equivariance"):
        mel = compute_cqt(y, p, use_kernels=use_cuda_kernels(
            cfg.use_pallas_cqt, device), conv_dtype="float32")
    return mel[0].cpu().numpy()


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="PitchClassNet transposition-equivariance check "
                    "(PyTorch)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_config_args(parser)
    parser.add_argument("--custom_cqt", action="store_true",
                        help="synthetic blob CQT instead of audio")
    parser.add_argument("--cqt_with_border", action="store_true")
    parser.add_argument("--wav", type=str, default="")
    parser.add_argument("--save", type=str, default="Equivariance_Test.npy")
    parser.add_argument("--heatmap", type=str, default="")
    parser.add_argument("--atol", type=float, default=1e-4)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    device = resolve_device(args.device)

    if args.wav:
        mel = wav_cqt(args.wav, cfg, device)
    else:
        mel = custom_cqt(cfg.octaves - 2, with_border=args.cqt_with_border)

    stack = shift_and_stack(cfg, mel, seed=cfg.seed, device=device)
    if args.save:
        np.save(args.save, stack)
    worst = check_equivariance(stack, args.atol)
    print(f"max equivariance deviation over ±12 semitone shifts: {worst:.3e}")
    if args.heatmap:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            fig, axes = plt.subplots(1, 2, figsize=(22, 10))
            axes[0].imshow(stack, aspect="auto")
            axes[0].set_title("raw key outputs per shift")
            adj = np.stack([np.roll(stack[i], -s)
                            for i, s in enumerate(SHIFTS)])
            axes[1].imshow(adj, aspect="auto")
            axes[1].set_title("rotation-corrected (rows must be identical)")
            for ax in axes:
                ax.set_xlabel("pitch class")
                ax.set_ylabel("semitone shift (12 .. -12)")
            fig.savefig(args.heatmap, dpi=100)
            print(f"heatmap -> {args.heatmap}")
        except ImportError:
            print("matplotlib unavailable; skipped heatmap")
    ok = worst < args.atol
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
