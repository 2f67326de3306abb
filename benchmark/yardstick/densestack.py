"""Roofline of a dense conv stack (`--denseblock`): the least time the
card could take for one ConvStack that is a DenseBlock, at the padded
shape it is given.

A dense stack of n layers on an input of cin channels runs, in layer i
(from 0), a bottleneck conv cin + i g -> m (m = max(cin // 2, 1) g, g
the growth, n_filters) and a conv m -> g, each after a BatchNorm and an
activation, on the concatenation of the block's input and every earlier
layer's features; the block gives cin + n g channels. A Pitch2Pitch
stack's convs are 1 x 1 and k x k over the pitch rows, bias-free; a
PitchClass2PitchClass stack's are 12 x 1 and 12 x k over the 12 pitch
classes (wrapped, so 12 output rows), with biases. Each conv is bounded
alone, by the larger of

  * its operations, 2 B H T cout cin kh kw over the output positions, at
    the float32 peak (the configuration states IEEE float32 for these
    stacks, which no tensor core computes), and
  * its least bytes: the float32 input read once, the output written
    once, the weights (and biases) read once;

and the stack's bound is the sum over its convs. BatchNorm, the
activations, the wrap and the concatenations add no bytes: a block can
normalize and activate as it reads a conv's input, and write each
layer's features into the block's output in place, where the next
layers read them.

`cat_bytes` is what the block's concatenations write as the system runs
them (one before each layer, and the block's output): the count the
program's `akx.stack` record carries, and against which the readers
check that they read the stacks this bound is of.
"""

from __future__ import annotations

import re

from .. import reference
from ..reference import serve as ref_serve
from . import stack_rows
from .roofline import F32_FLOPS, bound

PITCH_CLASSES = 12
F32 = 4


def conv_bound(B: int, H: int, T: int, cin: int, cout: int, kh: int,
               kw: int, bias: bool) -> dict:
    """One conv's bound: (B, cin, H, T) -> (B, cout, H, T), float32."""
    flops = 2 * B * H * T * cout * cin * kh * kw
    nbytes = F32 * (B * H * T * (cin + cout) + cout * cin * kh * kw
                    + (cout if bias else 0))
    return dict(bound(nbytes, flops, F32_FLOPS), flops=flops, bytes=nbytes)


def widths(g: dict) -> list:
    """(cin, cout, kh, kw) of each conv of a stack of geometry g, in the
    order it runs them."""
    grow, mid, k = g["growth"], g["mid"], g["kw"]
    kh1, kh = (PITCH_CLASSES, PITCH_CLASSES) if g["equivariant"] else (1, k)
    out = []
    for i in range(g["layers"]):
        out.append((g["cin"] + i * grow, mid, kh1, 1))
        out.append((mid, grow, kh, k))
    return out


def convs(g: dict) -> int:
    """The convolutions a stack of geometry `g` runs."""
    return 2 * g["layers"]


def stack_bound(g: dict) -> dict:
    """A dense stack's bound: the sum of its convs' bounds, with their
    operations and bytes."""
    parts = [conv_bound(g["B"], g["H"], g["T"], ci, co, kh, kw,
                        bias=g["equivariant"])
             for ci, co, kh, kw in widths(g)]
    return {"bound_s": sum(p["bound_s"] for p in parts),
            "flops": sum(p["flops"] for p in parts),
            "bytes": sum(p["bytes"] for p in parts),
            "convs": len(parts)}


def cat_bytes(g: dict, itemsize: int = F32) -> int:
    """Bytes the block's concatenations write: before layer i, the input
    and i layers' features; then the block's output."""
    channels = sum(g["cin"] + i * g["growth"] for i in range(g["layers"] + 1))
    return itemsize * g["B"] * g["H"] * g["T"] * channels


def stacks(model: dict, *, B: int, T: int) -> list:
    """The geometry of each dense ConvStack of a configuration, in the
    order the forward runs them (each tower: layer 0's pitch-class stack,
    then each later layer's Pitch2Pitch and pitch-class stacks), at B
    clips of T padded frames; [] where the stacks are not dense."""
    if not model.get("denseblock"):
        return []
    ref = reference.of(model)
    k, nf, n = model["kernel_size"], model["n_filters"], model["conv_layers"]

    def stack(name, H, t, cin, equivariant):
        return {"name": name, "B": B, "H": H, "T": t, "kw": k, "cin": cin,
                "growth": nf, "mid": ref.bottleneck(cin, nf), "layers": n,
                "equivariant": equivariant}

    out = []
    for bpo in ref_serve.bins_of(model):
        t = T
        for layer in range(model["num_layers"]):
            if layer == 0:
                out.append(stack(f"{bpo}.0.pc2pc", PITCH_CLASSES, t, 1, True))
                continue
            prev_p, prev_pc, out_p, _ = ref.layer_channels(layer, nf, n)
            out.append(stack(f"{bpo}.{layer}.p2p", model["octaves"] * bpo, t,
                             prev_p + prev_pc, False))
            out.append(stack(f"{bpo}.{layer}.pc2pc", PITCH_CLASSES, t,
                             out_p + prev_pc, True))
            t //= model["time_pool_size"]
    return out


# ---------------------------------------------------------------------------
# the program's dense stacks in a profiled slice
# ---------------------------------------------------------------------------

# the device rows of torch's concatenation kernel, every variant of it
# (in the resident cells `_vectorized` for a block's concatenations, the
# plain one for a pitch-class conv's wrap, whose slices are not
# contiguous), anchored at the start of the name so that no other kernel
# that happens to contain the word is taken
CAT_ROW = re.compile(
    r"^void at::native::\(anonymous namespace\)::CatArrayBatchedCopy\w*<")
# torch copies a concatenation of one tensor (the input of a block's first
# layer) with a device-to-device copy instead
LONE_CAT_ROW = "Memcpy DtoD (Device -> Device)"


def is_cat(row) -> bool:
    """A launch of the concatenation kernel."""
    return CAT_ROW.match(row.name) is not None


def wraps(g: dict) -> int:
    """The wraps of one layer of a stack of geometry g: a pitch-class
    stack wraps the input of each of its two convs over the pitch
    classes, with the concatenation kernel; a Pitch2Pitch stack pads
    with zeros inside its convs."""
    return 2 if g["equivariant"] else 0


def cat_rows(g: dict) -> int:
    """The concatenation kernel's launches in one stack of geometry g:
    each of the block's concatenations of two tensors or more (before
    layers 2 .. n, and the block's output), and each wrap."""
    return g["layers"] * (1 + wraps(g))


def block_concatenations(g: dict, rows: list) -> list:
    """Of one stack's rows (all `cat_rows(g)` concatenation launches
    among them), those that copy for the block's concatenations: the
    lone copy of the first layer's input, and the concatenation
    launches before each later layer and for the block's output. Each
    layer launches its concatenation (from the second layer) and then
    its wraps, so in launch order the block's are the (1 + wraps)-th,
    the 2 (1 + wraps)-th, and so on; the wraps are left out."""
    cats = [r for r in sorted(rows, key=lambda r: r.launch_us) if is_cat(r)]
    every = 1 + wraps(g)
    return ([r for r in rows if r.name == LONE_CAT_ROW]
            + [cats[i * every - 1] for i in range(1, g["layers"] + 1)])


def fits(span, g: dict) -> bool:
    """A dense span's record is of a stack of geometry g: its convs,
    layers and concatenation bytes (from the input's shape) all agree."""
    return (span.counts.get("convs"), span.counts["dense_layers"],
            span.counts.get("cat_bytes")) == (convs(g), g["layers"],
                                              cat_bytes(g))


def placed(profile, found: list, shapes: list) -> list | None:
    """[(span, geometry, rows)] of each dense `akx.stack` span (its record
    carries `dense_layers`) in the profiled calls, in the order they ran,
    with the device rows launched in it and the last launches that
    placement left out, up to its `cat_rows` (`stack_rows.placed`);
    None where there are none, where a call's dense spans differ from
    `shapes` in number, or where a span's `convs`, `dense_layers` or
    `cat_bytes` differ from its geometry's."""
    return stack_rows.placed(profile, found, shapes, "dense_layers", fits,
                             cat_rows, is_cat)
