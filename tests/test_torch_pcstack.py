"""PyTorch port: the pitch-class stacks' kernel (ops/pcstack_cuda.py,
csrc/pcconv.cu) off the card.

Here every CPU tensor takes the kernel's plain version, which must equal
the module path (models/blocks.py: EquivariantConv with
same_depth_padding, eval BatchNorm, leaky-ReLU; ResBlock's second conv
adding the block's input) conv by conv and for whole stacks, in float64
and in float32, at odd T and T under the 7 taps. A ConvStack resolves
the kernel (ConvStack.kernel, ops/stack_kernels.py) where it is an
equivariant kernel-7 stack, plain or residual, whose every conv has the
published widths, and runs it only in eval mode on float32 input; kernel
C and resconv7 take exactly the stacks they took. The akx.stack record
of a stack built for it carries pc_kernel. The benchmark's readers of
that count and of the stacks' roofline (pc_stack_kernel_share,
pc_stack_roofline, yardstick/pcstack.py) are held on recorded spans.
The kernel itself is held on the card by
tests/test_torch_pcstack_card.py and chip_smoke.py.
"""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from audio_key_estimation_torch.config import Config
from audio_key_estimation_torch.models import build_model
from audio_key_estimation_torch.models.blocks import (BatchNorm, ConvStack,
                                                      EquivariantConv,
                                                      leaky_relu)
from audio_key_estimation_torch.ops import pcstack_cuda as PS
from audio_key_estimation_torch.ops import stack_kernels as SK
from audio_key_estimation_torch.ops.stack_epilogue import fold_bn_affine
from audio_key_estimation_torch.utils.profiling import Span, spans

REPO = Path(__file__).resolve().parent.parent
LAYER = "conv stacks (models.blocks.ConvStack)"

# (B, T): odd, under the 7 taps, a single frame
GEOMETRIES = [(2, 9), (1, 5), (3, 2), (2, 1)]
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def seed_bn(module, g):
    """BatchNorm statistics and affines drawn from g, so that the
    epilogue's scale and shift matter."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, BatchNorm):
                n = m.running_var.numel()
                m.weight.copy_(1 + 0.2 * torch.randn(n, generator=g))
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                m.running_var.copy_(0.5 + torch.rand(n, generator=g))
    return module


def operands_in(conv, bn, dtype):
    """`PS.operands` computed in dtype (float64 folds BatchNorm in float64
    too)."""
    if dtype == torch.float32:
        return PS.operands(conv, bn)
    w = conv.conv2d.weight.detach().to(dtype)
    s = bn.weight.detach().to(dtype) / torch.sqrt(
        bn.running_var.to(dtype) + bn.eps)
    t = bn.bias.detach().to(dtype) - bn.running_mean.to(dtype) * s
    return PS.Conv(w.permute(1, 3, 2, 0).contiguous(),
                   conv.conv2d.bias.detach().to(dtype), s, t)


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=str)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("conv", PS.CONVS, ids=str)
def test_plain_conv_equals_the_module_path(conv, dtype, geometry):
    cin, cout, skip = conv
    B, T = geometry
    dt = DTYPES[dtype]
    g = torch.Generator().manual_seed(cin * 100 + cout)
    mod = EquivariantConv(cin, cout, 7, g, same_depth_padding=True)
    bn = seed_bn(BatchNorm(cout), g).eval()
    mod, bn = mod.to(dt), bn.to(dt)
    x = torch.randn(B, cin, 12, T, generator=g, dtype=dt)
    s = torch.randn(B, cout, 12, T, generator=g, dtype=dt) if skip \
        else None
    with torch.no_grad():
        y = bn(mod(x))
        want = leaky_relu(y if s is None else s + y)
        before = PS.pcconv.launches
        got = PS.pcconv(x, operands_in(mod, bn, dt), s)
        plain = PS.pcconv_plain(x, operands_in(mod, bn, dt), s)
    assert PS.pcconv.launches == before     # the CPU runs no kernel
    assert got.shape == (B, cout, 12, T) and got.dtype == dt
    assert torch.equal(got, plain)
    tol = dict(rtol=1e-5, atol=1e-6) if dt == torch.float32 else \
        dict(rtol=1e-12, atol=1e-13)
    torch.testing.assert_close(got, want, **tol)


STACKS = {"plain 1 -> 4": (1, 4, False), "plain 12 -> 16": (12, 16, False),
          "residual 1 -> 4": (1, 4, True),
          "residual 12 -> 16": (12, 16, True)}


def pc_stack(name, seed=0) -> ConvStack:
    cin, f, resblock = STACKS[name]
    g = torch.Generator().manual_seed(seed)
    stack = ConvStack(cin, f, 7, 3, True, g, fused_serving=True,
                      resblock=resblock)
    return seed_bn(stack, g).eval()


@pytest.mark.parametrize("T", [9, 5], ids=str)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(STACKS))
def test_the_stack_plain_equals_the_module_path(name, dtype, T):
    dt = DTYPES[dtype]
    stack = pc_stack(name, 3).to(dt)
    cin = STACKS[name][0]
    x = torch.randn(2, cin, 12, T, generator=torch.Generator().manual_seed(4),
                    dtype=dt)
    assert stack.kernel is SK.PCCONV
    assert stack.runs_kernel(x) is (dt == torch.float32)
    ops = [operands_in(c, b, dt) for c, b in stack.conv_pairs()]
    assert PS.residual(ops) is STACKS[name][2]
    before = PS.pcconv.launches
    with torch.no_grad():
        got = stack(x)
        plain = PS.pc_stack_plain(x, ops)
        want = x
        for m in stack.layer:
            want = m(want)
    assert PS.pcconv.launches == before
    tol = dict(rtol=1e-5, atol=1e-5) if dt == torch.float32 else \
        dict(rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(plain, want, **tol)
    torch.testing.assert_close(got, want, **tol)
    if dt == torch.float32:    # the gate ran the kernel's plain version
        assert torch.equal(got, plain)


def _x(dtype=torch.float32, cin=1, T=9):
    return torch.zeros(1, cin, 12, T, dtype=dtype)


# name: (ConvStack keywords, eval, input) -> whether it resolves pcconv,
# and whether the gate takes x
GATE = {
    "layer 0, eval float32": (dict(), True, _x(), True, True),
    "layer 1": (dict(in_ch=12, out_ch=16), True, _x(cin=12), True, True),
    "residual layer 0": (dict(resblock=True), True, _x(), True, True),
    "residual layer 1": (dict(in_ch=12, out_ch=16, resblock=True), True,
                         _x(cin=12), True, True),
    "training": (dict(), False, _x(), True, False),
    "bf16 input": (dict(), True, _x(torch.bfloat16), True, False),
    "float64 input": (dict(), True, _x(torch.float64), True, False),
    "fused_serving off": (dict(fused_serving=False), True, _x(), True,
                          False),
    "T 2": (dict(), True, _x(T=2), True, False),
    "dense": (dict(denseblock=True), True, _x(), False, False),
    "kernel 5": (dict(kernel_size=5), True, _x(), False, False),
    "n_filters 2": (dict(out_ch=2), True, _x(), False, False),
    "layer 1 at 16 -> 8": (dict(in_ch=16, out_ch=8), True, _x(cin=16),
                           False, False),
    "stem 12 -> 16, blocks of 4": (dict(in_ch=12, out_ch=4, resblock=True),
                                   True, _x(cin=12), False, False),
    "not equivariant": (dict(equivariant=False), True, _x(), False, False),
}


@pytest.mark.parametrize("name", sorted(GATE))
def test_the_gate(name):
    kw, eval_mode, x, built, takes = GATE[name]
    args = dict(in_ch=1, out_ch=4, kernel_size=7, conv_layers=3,
                equivariant=True, fused_serving=True)
    args.update(kw)
    stack = ConvStack(generator=torch.Generator().manual_seed(0), **args)
    stack.train(not eval_mode)
    assert (stack.kernel is SK.PCCONV) is built
    assert (built and stack.runs_kernel(x)) is takes


def _benchmark_config(name: str) -> Config:
    c = json.loads((REPO / "benchmark" / "configs" / f"{name}.json")
                   .read_text())
    return Config(**c["model"], **c["runtime"], seed=0)


BENCHMARK_CONFIGS = ["pcn_default", "pcn_multi_scale", "pcn_resblock"]


@pytest.mark.parametrize("name", BENCHMARK_CONFIGS)
def test_every_pitch_class_stack_of_the_benchmarks_configurations(name):
    """Every pitch-class stack of the three configurations resolves
    pcconv and takes it in eval mode on float32, not on bf16; the
    Pitch2Pitch stacks keep the kernel they had (kernel C, or resconv7 in
    pcn_resblock), and training mode runs none."""
    cfg = _benchmark_config(name)
    model = build_model(cfg).eval()
    stacks = [m for m in model.modules() if isinstance(m, ConvStack)]
    pcs = [m for m in model.modules() if hasattr(m, "pc2pc")]
    pc = {id(m.pc2pc) for m in pcs}
    assert len(pc) == (4 if cfg.multi_scale else 2)
    x = torch.zeros(1, 1, 12, 20)
    p2p = SK.RESCONV7 if cfg.resblock else SK.CONV7
    assert [s.kernel for s in stacks] == [
        SK.PCCONV if id(s) in pc else p2p for s in stacks]
    assert all(s.runs_kernel(x) for s in stacks if id(s) in pc)
    assert not any(s.runs_kernel(x.bfloat16()) for s in stacks
                   if id(s) in pc)
    assert sum(SK.PCCONV.launches(s) for s in stacks if id(s) in pc) == {
        "pcn_default": 6, "pcn_multi_scale": 12, "pcn_resblock": 14}[name]
    model.train()
    assert not any(s.runs_kernel(x) for s in stacks)


def profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.mark.parametrize("name", BENCHMARK_CONFIGS)
def test_an_eval_forward_records_pc_kernel(name):
    """A CPU eval forward of each configuration: every pitch-class
    akx.stack record carries pc_kernel 1 (the kernel's plain version ran)
    and no hand_kernel; only pcn_resblock's Pitch2Pitch record carries
    hand_kernel."""
    cfg = _benchmark_config(name)
    model = build_model(cfg).eval()
    T = 200
    mels = [torch.randn(2, cfg.pitches, T, 1,
                        generator=torch.Generator().manual_seed(5))]
    if cfg.multi_scale:
        mels.append(torch.randn(2, cfg.octaves * 12, T, 1,
                                generator=torch.Generator().manual_seed(6)))
    seq = torch.tensor([T, 150], dtype=torch.int32)
    with profiled(), torch.no_grad():
        model(*mels, seq)
    found = [s for s in spans() if s.name == "akx.stack"]
    convs = 7 if cfg.resblock else 3
    pc = [s for s in found if "pc_kernel" in s.counts]
    rest = [s for s in found if "pc_kernel" not in s.counts]
    assert len(pc) == (4 if cfg.multi_scale else 2) and len(rest) == len(
        found) - len(pc) == len(pc) // 2
    assert all(s.counts == {"convs": convs,
                            "res_blocks": 3 if cfg.resblock else 0,
                            "pc_kernel": 1} for s in pc)
    assert all(s.counts.get("hand_kernel") == (1 if cfg.resblock else None)
               for s in rest)


# ---------------------------------------------------------------------------
# the benchmark's readers and the stacks' bound
# ---------------------------------------------------------------------------

def reader(name):
    path = REPO / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def recorded(pc, calls=2, outside=0, model=True):
    """Calls of an akx.model span holding a pitch-class akx.stack per
    entry of `pc` (its pc_kernel, or None for a record without it) and a
    Pitch2Pitch stack (no count); `outside` stacks built for the kernel,
    not taken, before the first call."""
    found, i = [], 0
    for c in range(calls):
        at = 10_000 * (c + 1)
        if model:
            found.append(Span(i, "akx.model", at, at + 5000, None, c, {}))
        parent = i
        i += 1
        for k, h in enumerate(pc):
            counts = {"convs": 3, "res_blocks": 0}
            if h is not None:
                counts["pc_kernel"] = h
            found.append(Span(i, "akx.stack", at + 100 * (k + 1),
                              at + 100 * (k + 1) + 50, parent, c, counts))
            i += 1
        found.append(Span(i, "akx.stack", at + 4000, at + 4050, parent, c,
                          {"convs": 3, "res_blocks": 0}))
        i += 1
    for k in range(outside):
        found.append(Span(i + k, "akx.stack", 10 * k, 10 * k + 5, None,
                          None, {"convs": 3, "res_blocks": 0,
                                 "pc_kernel": 0}))
    return found


SHARES = {   # name: (recorded spans' arguments, share)
    "every stack built for the kernel": (dict(pc=(1, 1)), 100.0),
    "one in three": (dict(pc=(1, 0, 0), calls=3), 100.0 / 3),
    "none": (dict(pc=(0, 0)), 0.0),
    "stacks outside the calls left out": (dict(pc=(1,), outside=4), 100.0),
    "a program before the count": (dict(pc=(None, None)), None),
    "no stack built for the kernel": (dict(pc=()), None),
    "no model span": (dict(pc=(1,), model=False), None),
}


@pytest.mark.parametrize("name", sorted(SHARES))
def test_the_kernel_share_reader(name, monkeypatch):
    from audio_key_estimation_torch.utils import profiling
    kw, want = SHARES[name]
    found = recorded(**kw)
    monkeypatch.setattr(profiling, "spans", lambda: found)
    mod = reader("pc_stack_kernel_share")
    assert (mod.LAYER, mod.UNIT, mod.MOVES, mod.SOURCE) == (
        LAYER, "%", "device_audio_min_per_s", "program_counter")
    got = mod.read(None)
    assert got == (None if want is None else pytest.approx(want))


def _model(name):
    c = json.loads((REPO / "benchmark" / "configs" / f"{name}.json")
                   .read_text())
    return {**c["model"], "reference": c["reference"],
            "bins_per_octave": 12 if c["model"]["only_semitones"] else 36}


# (name, cin, f, convs, GFLOP) of each pitch-class stack at 256 clips of
# 901 frames, as the benchmark's cells run them
BOUND_STACKS = {
    "pcn_default": [("36.0.pc2pc", 1, 4, 3, 16.7),
                    ("36.1.pc2pc", 12, 16, 3, 327.4)],
    "pcn_multi_scale": [("36.0.pc2pc", 1, 4, 3, 16.7),
                        ("36.1.pc2pc", 12, 16, 3, 327.4),
                        ("12.0.pc2pc", 1, 4, 3, 16.7),
                        ("12.1.pc2pc", 12, 16, 3, 327.4)],
    "pcn_resblock": [("36.0.pc2pc", 1, 4, 7, 91.1),
                     ("36.1.pc2pc", 12, 16, 7, 1517.8)],
}


@pytest.mark.parametrize("name", BENCHMARK_CONFIGS)
def test_the_stacks_bound(name):
    from benchmark.yardstick import pcstack, resstack
    shapes = pcstack.stacks(_model(name), B=256, T=901)
    assert [(g["name"], g["cin"], g["f"], pcstack.convs(g),
             round(pcstack.stack_bound(g)["flops"] / 1e9, 1))
            for g in shapes] == BOUND_STACKS[name]
    g = shapes[-1]
    b = pcstack.stack_bound(g)
    assert b["bound_s"] == pytest.approx(sum(
        resstack.conv_bound(256, 12, 901, ci, co, 12, 7, skip=s)["bound_s"]
        for ci, co, s in pcstack.widths(g)))
    assert pcstack.stacks({**_model(name), "denseblock": True}, B=2,
                          T=9) == []


class _Readings:
    def __init__(self, model, profile):
        self.model = model
        self.profile = profile
        # one call: 2 clips of 1 + 100 // 10 = 11 frames
        self.geometry = {"cqts": [{"B": 2, "L": 100, "hop": 10}]}


def _row(name, launch, dur=1000.0):
    from benchmark.yardstick.profile import Row
    return Row(name, launch + 5, launch + 5 + dur, launch)


KERNEL_ROW = ("void (anonymous namespace)::pitch_class_conv_kernel<16, 16, "
              "false>((anonymous namespace)::PcConvArgs)")

ROOFLINES = {   # name: (what differs from the sound recording, rows read)
    "every launch inside its span": ({}, 6),
    "a stack's last launch after its span": (dict(late=True), 6),
    "a program before the count": (dict(pc=None), None),
    "counts that differ from the bound's": (dict(convs=7), None),
    "a stack on the library's convs": (dict(pc=0, rows=False, late=True),
                                       5),
    "kernel rows missing": (dict(rows=False), None),
}


@pytest.mark.parametrize("name", sorted(ROOFLINES))
def test_the_roofline_reader(name, monkeypatch):
    """Two pcn_default stacks in one call: the bound over the device time
    of the rows launched in them; where the last pcconv launch of a stack
    falls after the placed span, the next kernel row is taken."""
    from audio_key_estimation_torch.utils import profiling
    from benchmark.yardstick import pcstack
    from benchmark.yardstick.profile import Profile
    kw, n_rows = ROOFLINES[name]
    pc, convs = kw.get("pc", 1), kw.get("convs", 3)
    counts = {"convs": convs, "res_blocks": 0}
    if pc is not None:
        counts["pc_kernel"] = pc
    found = [Span(0, "akx.model", 1_000_000, 5_000_000, None, 0, {}),
             Span(1, "akx.stack", 1_100_000, 1_200_000, 0, 0, counts),
             Span(2, "akx.stack", 2_000_000, 2_100_000, 0, 0, counts)]
    rows = []
    for start in (1100, 2000):
        times = [start + 10, start + 20, start + 30]
        if kw.get("late") and start == 2000:
            times[-1] = 2105         # launched after its span closed
        for t in times:
            rows.append(_row(KERNEL_ROW if kw.get("rows", True)
                             else "elementwise", t))
    rows.append(_row("max_pool", 2200, 500.0))
    profile = Profile(rows, [("bench.model", 1000.0, 5000.0)], 0.01)
    monkeypatch.setattr(profiling, "spans", lambda: found)
    mod = reader("pc_stack_roofline")
    assert (mod.LAYER, mod.UNIT, mod.MOVES, mod.SOURCE) == (
        LAYER, "%", "device_audio_min_per_s", "device_trace")
    r = _Readings(_model("pcn_default"), profile)
    got = mod.read(r)
    if n_rows is None:
        assert got is None
        return
    bound = sum(pcstack.stack_bound(g)["bound_s"]
                for g in pcstack.stacks(r.model, B=2, T=11))
    assert got == pytest.approx(100.0 * bound / (n_rows * 1000.0 / 1e6))


@pytest.mark.parametrize("name", ["pc_stack_kernel_share",
                                  "pc_stack_roofline"])
def test_the_metrics_are_declared_for_the_resident_cells(name):
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    m = {m["name"]: m for m in bench["per_layer"]}[name]
    assert m == {"name": name, "unit": "%", "better": "higher",
                 "source": "program_counter" if name.endswith("share")
                 else "device_trace",
                 "layer": LAYER, "moves": "device_audio_min_per_s",
                 "workloads": ["multi_scale.resident", "default.resident",
                               "resblock.resident"]}
    assert [m["name"] for m in bench["per_layer"][-2:]] == [
        "pc_stack_kernel_share", "pc_stack_roofline"]


# ---------------------------------------------------------------------------
# the wrapper's contract
# ---------------------------------------------------------------------------

def test_operands_are_the_modules():
    stack = pc_stack("residual 12 -> 16", 6)
    block = stack.layer[3]
    conv, bn = block.conv2, block.b2
    ops = PS.operands(conv, bn)
    assert torch.equal(ops.weight,
                       conv.conv2d.weight.detach().permute(1, 3, 2, 0))
    assert torch.equal(ops.bias, conv.conv2d.bias.detach())
    s, t = fold_bn_affine(bn.weight, bn.bias, bn.running_mean,
                          bn.running_var, bn.eps)
    assert torch.equal(ops.scale, s) and torch.equal(ops.shift, t)
    assert all(v.is_contiguous() and v.dtype == torch.float32 for v in ops)
    assert [tuple(c.weight.shape) for c in stack.kernel.operands(
        stack.conv_pairs())] == [(12, 7, 12, 16)] + [
        (16, 7, 12, 32), (32, 7, 12, 16)] * 3


def test_supported_widths():
    def built_for(kind, cin, f, k=7, equivariant=True):
        return SK.PCCONV.built_for(kind, equivariant, k, [cin, f, f], f)
    assert all(built_for(kind, cin, f) for kind in ("plain", "residual")
               for cin, f in ((1, 4), (12, 16)))
    assert not any(built_for(*a) for a in (
        ("dense", 1, 4), ("plain", 12, 8), ("plain", 5, 8),
        ("residual", 4, 8), ("plain", 1, 4, 5), ("plain", 1, 4, 7, False)))
    assert SK.kernel_for("plain", True, 7, [1, 4, 4], 4) is SK.PCCONV
    assert SK.kernel_for("residual", False, 7, [5, 8, 8], 8) is SK.RESCONV7
    assert SK.kernel_for("plain", False, 7, [5, 8, 8], 8) is SK.CONV7
    assert [k.recorded for k in SK.KERNELS] == [None, "hand_kernel",
                                                "pc_kernel"]
