"""Roofline of a transposition-equivariant pitch-class stack
(PitchClass2PitchClass): the least time the card could take for one such
ConvStack, plain or residual (`--resblock`), at the padded shape it is
given.

A plain stack runs its convs cin -> f, then f -> f; a residual one a
stem cin -> f and, in each block, f -> 2f and 2f -> f with the block's
input added. Each conv is 12 x k over the 12 pitch classes (wrapped, so
12 output rows) and is bounded alone as `resstack.conv_bound` bounds it:
the larger of its float32 operations at the float32 peak and its least
bytes (input and output once, the weights once, a block's input once
more for the add; BatchNorm, leaky-ReLU and the wrap fused into the
conv). The stack's bound is the sum over its convs.
"""

from __future__ import annotations

from .. import reference
from ..reference import serve as ref_serve
from .resstack import PITCH_CLASSES, conv_bound


def widths(g: dict) -> list:
    """(cin, cout, skip channels) of each conv of a stack of geometry g."""
    f = g["f"]
    if not g["blocks"]:
        return [(g["cin"], f, 0)] + [(f, f, 0)] * (g["layers"] - 1)
    return [(g["cin"], f, 0)] + [(f, 2 * f, 0), (2 * f, f, f)] * g["blocks"]


def convs(g: dict) -> int:
    """The convolutions a stack of geometry `g` runs."""
    return len(widths(g))


def stack_bound(g: dict) -> dict:
    """A pitch-class stack's bound: the sum of its convs' bounds, with
    their operations and bytes."""
    parts = [conv_bound(g["B"], PITCH_CLASSES, g["T"], ci, co,
                        PITCH_CLASSES, g["kw"], skip=s)
             for ci, co, s in widths(g)]
    return {"bound_s": sum(p["bound_s"] for p in parts),
            "flops": sum(p["flops"] for p in parts),
            "bytes": sum(p["bytes"] for p in parts),
            "convs": len(parts)}


def stacks(model: dict, *, B: int, T: int) -> list:
    """The geometry of each pitch-class ConvStack of a configuration, in
    the order the forward runs them (each tower, each layer), at B clips
    of T padded frames; [] where the stacks are dense."""
    if model.get("denseblock"):
        return []
    channels = reference.of(model).layer_channels
    k, nf, n = model["kernel_size"], model["n_filters"], model["conv_layers"]
    blocks = n if model.get("resblock") else 0
    out = []
    for bpo in ref_serve.bins_of(model):
        t = T
        for layer in range(model["num_layers"]):
            g = {"B": B, "T": t, "kw": k, "layers": n, "blocks": blocks}
            if layer == 0:
                out.append(dict(g, name=f"{bpo}.0.pc2pc", cin=1, f=nf))
                continue
            _, prev_pc, out_p, out_pc = channels(layer, nf)
            out.append(dict(g, name=f"{bpo}.{layer}.pc2pc",
                            cin=out_p + prev_pc, f=out_pc))
            t //= model["time_pool_size"]
    return out
