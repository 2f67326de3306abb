"""PyTorch port: the residual Pitch2Pitch stack's kernel
(ops/resstack_cuda.py, csrc/resconv7.cu) off the card.

Here every CPU tensor takes the kernel's plain version, which must equal
the module path (models/blocks.py ResBlock: conv + bias, eval BatchNorm,
the block's input added in its second conv, leaky-ReLU) in float32, conv
by conv and for the whole stack, at small H and T, ragged against the
kernel's 32-row, 64- or 32-position tiles. A ConvStack resolves the
kernel (ConvStack.kernel, ops/stack_kernels.py) where it is residual,
non-equivariant, kernel 7, at the published widths, and runs it only in
eval mode on float32 input with H, T >= 3; each stack of every variant
resolves at most one kernel; the akx.stack record
of a stack built for the kernel keeps convs 7 and res_blocks 3 and
carries hand_kernel, other stacks' records carry none; and the
benchmark's reader of that count (res_stack_kernel_share) reads recorded
spans. The kernel itself is held on the card by
tests/test_torch_resconv7_card.py and chip_smoke.py.
"""

import copy
import importlib.util
import json
import pickle
from pathlib import Path

import pytest
import torch

from audio_key_estimation_torch.config import Config
from audio_key_estimation_torch.models import PitchClassNet, build_model
from audio_key_estimation_torch.models.blocks import (CircularConv,
                                                      ConvStack, leaky_relu)
from audio_key_estimation_torch.ops import convstack_cuda as CS
from audio_key_estimation_torch.ops import resstack_cuda as RS
from audio_key_estimation_torch.ops import stack_kernels as SK
from audio_key_estimation_torch.utils.profiling import Span, spans
from torch_parity import VARIANTS

REPO = Path(__file__).resolve().parent.parent

# (B, H, T): ragged T, H under a tile, the smallest axes the gate takes
GEOMETRIES = [(2, 13, 37), (1, 3, 3), (2, 40, 70), (1, 33, 65), (1, 5, 129)]


def residual_stack(seed=0, **kw) -> ConvStack:
    """The published Pitch2Pitch residual stack (5 -> 8, 3 blocks of 8 ->
    16 -> 8), eval mode, with BatchNorm statistics and affines drawn from
    the seed so that the epilogue's scale and shift matter."""
    g = torch.Generator().manual_seed(seed)
    args = dict(fused_serving=True, resblock=True)
    args.update(kw)
    stack = ConvStack(5, 8, 7, 3, False, g, **args).eval()
    with torch.no_grad():
        for m in stack.modules():
            if hasattr(m, "running_var"):
                n = m.running_var.numel()
                m.weight.copy_(1 + 0.2 * torch.randn(n, generator=g))
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                m.running_var.copy_(0.5 + torch.rand(n, generator=g))
    return stack


def module_convs(stack):
    """Each conv of the stack as the module path computes it: (operands,
    f(x, skip))."""
    stem, bn = stack.layer[0], stack.layer[1]
    out = [(RS.operands(stem, bn), lambda x, s: leaky_relu(bn(stem(x))))]
    for blk in stack.layer[3:]:
        out.append((RS.operands(blk.conv1, blk.b1),
                    lambda x, s, b=blk: leaky_relu(b.b1(b.conv1(x)))))
        out.append((RS.operands(blk.conv2, blk.b2),
                    lambda x, s, b=blk: leaky_relu(s + b.b2(b.conv2(x)))))
    return out


CONV_ROLES = {"stem": 0, "conv1": 1, "conv2": 2}


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=str)
@pytest.mark.parametrize("role", sorted(CONV_ROLES))
def test_plain_conv_equals_the_module_path(role, geometry):
    B, H, T = geometry
    stack = residual_stack(1)
    ops, module = module_convs(stack)[CONV_ROLES[role]]
    cin, cout = ops.weight.shape[0], ops.weight.shape[-1]
    g = torch.Generator().manual_seed(2)
    x = torch.randn(B, cin, H, T, generator=g)
    skip = torch.randn(B, cout, H, T, generator=g) if role == "conv2" \
        else None
    assert (cin, cout, skip is not None) in RS.CONVS
    with torch.no_grad():
        got = RS.resconv7(x, ops, skip)
        want = module(x, skip)
    assert got.shape == (B, cout, H, T) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=str)
def test_the_gated_stack_equals_the_module_path(geometry):
    B, H, T = geometry
    stack = residual_stack(3)
    x = torch.randn(B, 5, H, T, generator=torch.Generator().manual_seed(4))
    assert stack.kernel is SK.RESCONV7 and stack.runs_kernel(x)
    before = RS.resconv7.launches
    with torch.no_grad():
        got = stack(x)
        want = x
        for m in stack.layer:
            want = m(want)
        plain = RS.residual_stack_plain(
            x, stack.kernel.operands(stack.conv_pairs()))
    assert RS.resconv7.launches == before     # the CPU runs no kernel
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, plain)


def _x(dtype=torch.float32, H=12, T=9, cin=5):
    return torch.zeros(1, cin, H, T, dtype=dtype)


# name: (ConvStack keywords, eval, input) -> whether the gate takes it
GATE = {
    "eval float32": (dict(), True, _x(), True),
    "training": (dict(), False, _x(), False),
    "equivariant": (dict(equivariant=True), True, _x(H=12), False),
    "bf16 input": (dict(), True, _x(torch.bfloat16), False),
    "float64 input": (dict(), True, _x(torch.float64), False),
    "plain stack": (dict(resblock=False), True, _x(), False),
    "dense stack": (dict(resblock=False, denseblock=True), True, _x(),
                    False),
    "fused_serving off": (dict(fused_serving=False), True, _x(), False),
    "kernel 5": (dict(kernel_size=5), True, _x(), False),
    "stem 4 -> 8": (dict(in_ch=4), True, _x(cin=4), False),
    "blocks of 4": (dict(out_ch=4), True, _x(), False),
    "H 2": (dict(), True, _x(H=2), False),
    "T 2": (dict(), True, _x(T=2), False),
    "H 3, T 3": (dict(), True, _x(H=3, T=3), True),
}


@pytest.mark.parametrize("name", sorted(GATE))
def test_the_gate(name):
    kw, eval_mode, x, want = GATE[name]
    args = dict(in_ch=5, out_ch=8, kernel_size=7, conv_layers=3,
                equivariant=False, fused_serving=True, resblock=True)
    args.update(kw)
    stack = ConvStack(generator=torch.Generator().manual_seed(0), **args)
    stack.train(not eval_mode)
    assert (stack.kernel is SK.RESCONV7 and stack.runs_kernel(x)) is want


# the layer-1 Pitch2Pitch stack's kernel for each variant of the matrix
# at kernel 7 and 4 filters (tests/test_torch_gate.py's widths), and for
# the published resblock model at the default Config; no other stack
# resolves one
RESOLVED = {"default": "conv7_layer", "resblock": "resconv7",
            "denseblock": None, "p2pc_conv": "conv7_layer",
            "pc2p_mem": "conv7_layer", "stay_sixth": "conv7_layer",
            "only_semitones": "conv7_layer", "max_pool": "conv7_layer",
            "three_layers": "conv7_layer", "resblock_pc2p_mem": None,
            "dense_p2pc_conv": None, "resblock published": "resconv7"}


# each layer's pitch-class stack's kernel where it is not pcconv's at
# every layer: dense stacks take none, and three_layers' layer-2 stack
# (48 -> 64) is wider than the kernel's
PC_RESOLVED = {"denseblock": [None, None], "dense_p2pc_conv": [None, None],
               "three_layers": ["pcconv", "pcconv", None]}


@pytest.mark.parametrize("name", sorted(RESOLVED))
def test_each_stack_resolves_at_most_one_kernel(name):
    """Kernel C for a plain stack at its geometry, resconv7 for a
    residual one whose stem is 5 -> 8, none for a dense stack or a
    residual stem 1 -> 8; pcconv for a plain or residual pitch-class
    stack at its widths (PC_RESOLVED); a model's copies keep the same
    entries."""
    assert set(RESOLVED) == {*VARIANTS, "resblock published"}
    kw = dict(resblock=True) if name == "resblock published" else {
        **dict(octaves=2, num_layers=2, conv_layers=3, n_filters=4,
               kernel_size=7, head_layers=2), **VARIANTS[name]}
    model = build_model(Config(fused_convstack=True, **kw))
    stacks = [m for m in model.modules() if isinstance(m, ConvStack)]
    assert stacks[1] is model.model[1].p2p
    layers = list(model.model)
    want = {layer.pc2pc: k for layer, k in zip(
        layers, PC_RESOLVED.get(name, ["pcconv"] * len(layers)))}
    want |= {layer.p2p: k for layer, k in zip(
        layers[1:], [RESOLVED[name]] + [None] * (len(layers) - 2))}
    assert len(want) == len(stacks)
    assert [s.kernel for s in stacks] == [
        want[s] and SK.named(want[s]) for s in stacks]
    # replicas (deep copies) and pickles share the entries
    for twin in (copy.deepcopy(model), pickle.loads(pickle.dumps(model))):
        assert all(a.kernel is b.kernel for a, b in zip(
            stacks, (m for m in twin.modules() if isinstance(m, ConvStack))))


def _benchmark_config(name: str) -> Config:
    c = json.loads((REPO / "benchmark" / "configs" / f"{name}.json")
                   .read_text())
    return Config(**c["model"], **c["runtime"], seed=0)


@pytest.mark.parametrize("name", ["pcn_default", "pcn_multi_scale",
                                  "pcn_resblock"])
def test_the_gate_in_the_benchmarks_configurations(name):
    """Only the residual configuration's Pitch2Pitch stacks take the
    kernel, in eval mode; the pitch-class stacks stay on the module path."""
    cfg = _benchmark_config(name)
    model = build_model(cfg).eval()
    stacks = [m for m in model.modules() if isinstance(m, ConvStack)]
    x = torch.zeros(1, 5, 288, 20)
    taken = [s.kernel is SK.RESCONV7 and s.runs_kernel(x) for s in stacks]
    want = [cfg.resblock and isinstance(s.layer[0], CircularConv)
            for s in stacks]
    assert taken == want and (name == "pcn_resblock") == any(taken)
    model.train()
    assert not any(s.runs_kernel(x) for s in stacks)


def profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


# name: (Config keywords, eval) -> the Pitch2Pitch record's hand_kernel
# (None: no stack is built for the kernel, so no record carries one), the
# pitch-class records' pc_kernel
SPAN_CASES = {"resblock": (dict(resblock=True), True, 1, 1),
              "resblock training": (dict(resblock=True), False, 0, 0),
              "resblock fused_convstack off": (
                  dict(resblock=True, fused_convstack=False), True, 0, 0),
              "plain": (dict(), True, None, 1)}


@pytest.mark.parametrize("case", sorted(SPAN_CASES))
def test_the_stack_span_carries_hand_kernel(case):
    """A resblock model's Pitch2Pitch akx.stack keeps convs 7 and
    res_blocks 3 and carries hand_kernel: 1 where the gate took it, 0 in
    training or with fused_convstack off. Its pitch-class stacks, and
    every stack of a plain model (kernel C's included), carry none; the
    pitch-class stacks carry pc_kernel instead, 1 where pcconv's gate took
    them."""
    kw, eval_mode, hand, pc = SPAN_CASES[case]
    resblock = kw.get("resblock", False)
    cfg = Config(**{**dict(octaves=2, num_layers=2, conv_layers=3,
                           n_filters=4, kernel_size=7, head_layers=2,
                           fused_convstack=True), **kw})
    model = PitchClassNet(cfg).train(not eval_mode)
    mel = torch.randn(2, cfg.pitches, 40, 1,
                      generator=torch.Generator().manual_seed(5))
    seq = torch.tensor([40, 33], dtype=torch.int32)
    with profiled(), torch.no_grad():
        model(mel, seq)
    stacks = [s for s in spans() if s.name == "akx.stack"]
    p2p = model.model[1].p2p
    want = [{"convs": 7 if resblock else 3,
             "res_blocks": 3 if resblock else 0,
             **({"hand_kernel": hand} if m is p2p and hand is not None
                else {}),
             **({} if m is p2p else {"pc_kernel": pc})}
            for m in model.modules() if isinstance(m, ConvStack)]
    assert len(stacks) == len(want) == 3

    def key(counts):
        return sorted(counts.items())
    assert sorted(key(s.counts) for s in stacks) == sorted(map(key, want))


# ---------------------------------------------------------------------------
# the benchmark's reader of hand_kernel, on recorded spans
# ---------------------------------------------------------------------------

def reader():
    path = REPO / "benchmark" / "metrics" / "res_stack_kernel_share.py"
    spec = importlib.util.spec_from_file_location(
        "res_stack_kernel_share", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def recorded(hand, calls=2, outside=0, model=True):
    """Calls of an akx.model span holding a residual akx.stack per entry
    of `hand` (its hand_kernel, or None for a record without it), one
    equivariant residual stack and one plain stack (neither built for the
    kernel: no count); `outside` stacks built for the kernel, not taken,
    before the first call."""
    found, i = [], 0
    for c in range(calls):
        at = 10_000 * (c + 1)
        if model:
            found.append(Span(i, "akx.model", at, at + 5000, None, c, {}))
        parent = i
        i += 1
        for k, h in enumerate(hand):
            counts = {"convs": 7, "res_blocks": 3}
            if h is not None:
                counts["hand_kernel"] = h
            found.append(Span(i, "akx.stack", at + 100 * (k + 1),
                              at + 100 * (k + 1) + 50, parent, c, counts))
            i += 1
        for k, counts in enumerate(({"convs": 7, "res_blocks": 3},
                                    {"convs": 3, "res_blocks": 0})):
            found.append(Span(i, "akx.stack", at + 4000 + 100 * k,
                              at + 4050 + 100 * k, parent, c, counts))
            i += 1
    for k in range(outside):
        found.append(Span(i + k, "akx.stack", 10 * k, 10 * k + 5, None,
                          None, {"convs": 7, "res_blocks": 3,
                                 "hand_kernel": 0}))
    return found


SHARES = {   # name: (recorded spans' arguments, share)
    "every stack built for the kernel": (dict(hand=(1,)), 100.0),
    "one in three": (dict(hand=(1, 0, 0), calls=3), 100.0 / 3),
    "none": (dict(hand=(0, 0)), 0.0),
    "stacks outside the calls left out": (dict(hand=(1,), outside=4), 100.0),
    "a program before the count": (dict(hand=(None, None)), None),
    "no stack built for the kernel": (dict(hand=()), None),
    "no model span": (dict(hand=(1,), model=False), None),
}


@pytest.mark.parametrize("name", sorted(SHARES))
def test_the_kernel_share_reader(name, monkeypatch):
    from audio_key_estimation_torch.utils import profiling
    kw, want = SHARES[name]
    found = recorded(**kw)
    monkeypatch.setattr(profiling, "spans", lambda: found)
    mod = reader()
    assert (mod.LAYER, mod.UNIT, mod.MOVES, mod.SOURCE) == (
        "conv stacks (models.blocks.ConvStack)", "%",
        "device_audio_min_per_s", "program_counter")
    got = mod.read(None)
    assert got == (None if want is None else pytest.approx(want))


def test_the_kernel_share_is_declared_for_the_residual_cell():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    m = {m["name"]: m for m in bench["per_layer"]}["res_stack_kernel_share"]
    assert m == {"name": "res_stack_kernel_share", "unit": "%",
                 "better": "higher", "source": "program_counter",
                 "layer": "conv stacks (models.blocks.ConvStack)",
                 "moves": "device_audio_min_per_s",
                 "workloads": ["resblock.resident"]}
    names = [m["name"] for m in bench["per_layer"]]
    assert names.index(m["name"]) == names.index("res_stack_roofline") + 1


# ---------------------------------------------------------------------------
# the wrapper's contract
# ---------------------------------------------------------------------------

def test_supported_widths():
    def built_for(c, f):
        return SK.RESCONV7.built_for("residual", False, 7, [c], f)
    assert built_for(5, 8)
    assert not any(built_for(c, f) for c, f in ((4, 8), (5, 4), (5, 16),
                                                (8, 8)))


# demangled device rows as the profiler names them: kernel C's, and
# residual conv kernels under their present and their first name
KERNEL_ROWS = {
    "void (anonymous namespace)::conv7_kernel<0, 1>((anonymous "
    "namespace)::Conv7Args)": True,
    "void (anonymous namespace)::conv7_kernel<2, 2>((anonymous "
    "namespace)::Conv7Args)": True,
    "void (anonymous namespace)::residual_conv_kernel<16, 8, true>("
    "(anonymous namespace)::ResConvArgs)": False,
    "void (anonymous namespace)::resconv7_kernel<5, 8, false>((anonymous "
    "namespace)::ResConvArgs)": False,
}


@pytest.mark.parametrize("row", sorted(KERNEL_ROWS))
def test_kernel_c_rows_are_found_by_their_whole_name(row):
    """chip_smoke.py takes a device row for kernel C's only by its whole
    demangled name, so no other kernel whose name holds the substring
    conv7_kernel is counted as kernel C."""
    import chip_smoke
    assert bool(chip_smoke.KERNEL_C_ROW.search(row)) is KERNEL_ROWS[row]


def test_operands_are_the_modules():
    stack = residual_stack(6)
    conv, bn = stack.layer[3].conv2, stack.layer[3].b2
    ops = RS.operands(conv, bn)
    assert torch.equal(ops.weight, conv.weight.detach().permute(1, 2, 3, 0))
    assert torch.equal(ops.bias, conv.bias.detach())
    s, t = CS.fold_bn_affine(bn.weight, bn.bias, bn.running_mean,
                             bn.running_var, bn.eps)
    assert torch.equal(ops.scale, s) and torch.equal(ops.shift, t)
    assert all(v.is_contiguous() and v.dtype == torch.float32 for v in ops)
