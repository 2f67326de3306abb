"""What the serving kinds share: the system under test built from the
benchmark's weights, the kernels' geometry of one call, and the numbers
the check compares."""

from __future__ import annotations

import torch

from .. import reference, stand_in
from ..reference import serve as ref_serve

STACK_OUT = 8           # kernel C's stacks: 8 outputs, <= 8 inputs, 7x7
STACK_KERNEL = 7


def estimator(ctx, sd: dict):
    """The system's KeyEstimator on the run's device, loaded with the
    benchmark's weights (a copy on the host, in the reference's layout);
    the reference in its place where the run names a stand-in."""
    if ctx.stand_in:
        if ctx.stand_in not in stand_in.SERVING:
            raise ValueError(f"a serving cell takes the stand-ins "
                             f"{stand_in.SERVING}, not {ctx.stand_in!r}")
        return stand_in.Estimator(ctx, sd, ctx.stand_in)
    from audio_key_estimation_torch.predict import KeyEstimator
    host = {k: v.detach().cpu() for k, v in sd.items()}
    return KeyEstimator(ctx.program_config(), host, device=ctx.device)


def geometry(model: dict, runtime: dict, *, B: int, L: int, sr: int,
             hop: int, input_itemsize: int) -> dict:
    """One call's CQTs (kernels A and B) and kernel C's stacks at a padded
    (B, L) batch: each tower's Pitch2Pitch stacks that kernel C takes
    (plain, meaning neither residual nor dense blocks, as the system's
    `ConvStack.fusable` decides; 7x7, 8 outputs, <= 8 inputs, fused
    serving on), with the widths of the configuration's reference."""
    stream = 2 if model["cqt_stream_dtype"] == "bfloat16" else 4
    cqts = [{"B": B, "L": L, "sr": sr, "hop": hop, "bins_per_octave": b,
             "octaves": model["octaves"], "input_itemsize": input_itemsize,
             "stream_itemsize": stream} for b in ref_serve.bins_of(model)]
    stacks = []
    T = 1 + L // hop
    plain = not (model.get("resblock") or model.get("denseblock"))
    fused = runtime.get("fused_convstack") and plain
    channels = reference.of(model).layer_channels
    for b in (ref_serve.bins_of(model) if fused else ()):
        t = T
        for layer in range(1, model["num_layers"]):
            prev_p, prev_pc, out_p, _ = channels(layer, model["n_filters"])
            cin = prev_p + prev_pc
            if (out_p == STACK_OUT and cin <= STACK_OUT
                    and model["kernel_size"] == STACK_KERNEL):
                stacks.append({"B": B, "H": model["octaves"] * b, "T": t,
                               "cins": [cin] + [out_p] * (
                                   model["conv_layers"] - 1)})
            t //= model["time_pool_size"]
    return {"cqts": cqts, "stacks": stacks}


def rel_gap(got, ref) -> float:
    """max |got - ref| over the largest |ref|."""
    got = torch.as_tensor(got, dtype=torch.float32)
    ref = torch.as_tensor(ref, dtype=torch.float32).to(got.device)
    if got.shape != ref.shape:
        return float("inf")
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def prob_gap(got, ref) -> float:
    """The largest gap between the tonic probabilities (the softmax of
    each clip's tonic logits). The logits' own largest gap is set by a
    few bf16 roundings that flip, and reads as much on some seeds as
    TF32 does on others; the probabilities keep them apart."""
    got = torch.as_tensor(got, dtype=torch.float32)
    ref = torch.as_tensor(ref, dtype=torch.float32).to(got.device)
    if got.shape != ref.shape:
        return float("inf")
    return float((torch.softmax(got, -1) - torch.softmax(ref, -1))
                 .abs().max())


def abs_gap(got, ref) -> float:
    got = torch.as_tensor(got, dtype=torch.float32)
    ref = torch.as_tensor(ref, dtype=torch.float32).to(got.device)
    if got.shape != ref.shape:
        return float("inf")
    return float((got - ref).abs().max())
