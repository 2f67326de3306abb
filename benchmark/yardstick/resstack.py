"""Roofline of a residual conv stack (`--resblock`): the least time the
card could take for one ConvStack of residual blocks at the padded shape
it is given.

A residual stack runs a stem conv (cin -> f) and, in each of its blocks,
a conv f -> 2f and a conv 2f -> f, each followed by BatchNorm and
leaky-ReLU, the second after adding the block's input. Each conv is
bounded alone, by the larger of

  * its operations, 2 B H T cout cin kh kw over the output positions, at
    the float32 peak (the configurations state IEEE float32 for these
    stacks, which no tensor core computes), and
  * its least bytes: the float32 input read once, the output written
    once, the weights read once, and in a block's second conv the
    block's input read once more for the residual add; BatchNorm,
    leaky-ReLU and the circular pads are taken as fused into the convs,
    so they add no bytes;

and the stack's bound is the sum over its convs. A Pitch2Pitch conv is
k x k over the pitch rows (circular on both axes); a PitchClass2PitchClass
conv is 12 x k over the 12 pitch classes (wrapped, so 12 output rows).
"""

from __future__ import annotations

from .. import reference
from ..reference import serve as ref_serve
from .roofline import F32_FLOPS, bound

PITCH_CLASSES = 12
F32 = 4


def conv_bound(B: int, H: int, T: int, cin: int, cout: int, kh: int,
               kw: int, skip: int = 0) -> dict:
    """One conv's bound: (B, cin, H, T) -> (B, cout, H, T), float32, with
    `skip` channels of (B, skip, H, T) read for a residual add."""
    flops = 2 * B * H * T * cout * cin * kh * kw
    nbytes = F32 * (B * H * T * (cin + cout + skip)
                    + cout * cin * kh * kw + cout)
    return dict(bound(nbytes, flops, F32_FLOPS), flops=flops, bytes=nbytes)


def convs(g: dict) -> int:
    """The convolutions a stack of geometry `g` runs."""
    return 1 + 2 * g["blocks"]


def stack_bound(g: dict) -> dict:
    """A residual stack's bound: the sum of its convs' bounds, with their
    operations and bytes."""
    B, H, T, k, f = g["B"], g["H"], g["T"], g["kw"], g["f"]
    kh = g["kh"]
    parts = [conv_bound(B, H, T, g["cin"], f, kh, k)]
    for _ in range(g["blocks"]):
        parts.append(conv_bound(B, H, T, f, 2 * f, kh, k))
        parts.append(conv_bound(B, H, T, 2 * f, f, kh, k, skip=f))
    return {"bound_s": sum(p["bound_s"] for p in parts),
            "flops": sum(p["flops"] for p in parts),
            "bytes": sum(p["bytes"] for p in parts),
            "convs": len(parts)}


def stacks(model: dict, *, B: int, T: int) -> list:
    """The geometry of each ConvStack of a residual configuration, in the
    order the forward runs them (each tower: layer 0's pitch-class stack,
    then each later layer's Pitch2Pitch and pitch-class stacks), at B
    clips of T padded frames; [] where the stacks are not residual."""
    if not model.get("resblock"):
        return []
    channels = reference.of(model).layer_channels
    k, nf, n = model["kernel_size"], model["n_filters"], model["conv_layers"]
    out = []
    for bpo in ref_serve.bins_of(model):
        t = T
        for layer in range(model["num_layers"]):
            pc = {"B": B, "H": PITCH_CLASSES, "T": t, "kh": PITCH_CLASSES,
                  "kw": k, "blocks": n}
            if layer == 0:
                out.append(dict(pc, name=f"{bpo}.{layer}.pc2pc", cin=1,
                                f=nf))
                continue
            prev_p, prev_pc, out_p, out_pc = channels(layer, nf)
            out.append({"name": f"{bpo}.{layer}.p2p", "B": B,
                        "H": model["octaves"] * bpo, "T": t, "kh": k,
                        "kw": k, "blocks": n, "cin": prev_p + prev_pc,
                        "f": out_p})
            out.append(dict(pc, name=f"{bpo}.{layer}.pc2pc",
                            cin=out_p + prev_pc, f=out_pc))
            t //= model["time_pool_size"]
    return out
