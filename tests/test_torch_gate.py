"""PyTorch port: kernel C's gate across the PitchClassNet variants.

For every variant of the matrix (tests/torch_parity.py VARIANTS) at
kernel 7 and 4 filters (so the layer-1 Pitch2Pitch stack has 8 outputs)
with `fused_convstack` on: the kernel C launches of one eval forward of
the port (its plain version on the CPU, counted per layer) equal the
JAX package's gate (models/blocks.py:301-312, traced abstractly, without
its TPU lane constraints) and the sum over the port's stacks that
resolve kernel C (`ConvStack.kernel`, ops/stack_kernels.py), each counted
by the entry's own launches.
Where the gate takes a stack, that stack (bf16 kernel numerics) is held
against the flax ConvStack on the same weights and input at
tests/test_convstack_pallas.py:101-103's bars, and the whole fused model
against the plain one at :180's. The launches chip_smoke.py demands of
each variant it serves at the default widths are the JAX gate's there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_key_estimation_tpu.config import Config
from audio_key_estimation_tpu.models import PitchClassNet as JaxNet
from audio_key_estimation_tpu.models import blocks as jax_blocks
from audio_key_estimation_tpu.ops import convstack_pallas as CP

from audio_key_estimation_torch.models import PitchClassNet
from audio_key_estimation_torch.models.blocks import ConvStack
from audio_key_estimation_torch.ops import convstack_cuda as CS
from audio_key_estimation_torch.ops import stack_kernels as SK
from torch_parity import VARIANTS

BASE = dict(octaves=2, num_layers=2, conv_layers=3, n_filters=4,
            kernel_size=7, head_layers=2, fused_convstack=True)
T = 64


def _cfg(name):
    return Config(**{**BASE, **VARIANTS[name]})


def jax_gate_launches(cfg, monkeypatch) -> int:
    """Kernel launches the JAX model's gate dispatches in one eval apply,
    one per layer of each stack it takes; traced, nothing compiled."""
    layers = []

    def counting(x, stack_layers, **kw):
        layers.append(len(stack_layers))
        return jnp.zeros(x.shape[:3] + (8,), x.dtype)

    monkeypatch.setattr(CP, "fused_convstack", counting)
    monkeypatch.setattr(CP, "supported_geometry", lambda shape, cins: (
        all(ci <= 8 for ci in cins) and shape[3] == cins[0]))
    model = JaxNet(cfg)
    mel = jax.ShapeDtypeStruct((1, cfg.pitches, T, 1), jnp.float32)
    shapes = jax.eval_shape(
        lambda m: model.init(jax.random.PRNGKey(0), m, None, False), mel)
    assert not layers, "init must take the plain path"
    jax.eval_shape(lambda v, m: model.apply(v, m, None, False), shapes, mel)
    return sum(layers)


def _seeded(net: torch.nn.Module, seed: int) -> torch.nn.Module:
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in net.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=g))
    return net.eval()


def _flax_stack(stack: ConvStack, x: torch.Tensor) -> np.ndarray:
    """The flax ConvStack (eval) on the port stack's weights."""
    convs, bns = stack.layer[0::3], stack.layer[1::3]
    params, stats = {}, {}
    for i, (c, b) in enumerate(zip(convs, bns)):
        params[f"seq_{3 * i}"] = {
            "kernel": jnp.asarray(c.weight.detach().permute(2, 3, 1, 0)
                                  .numpy()),
            "bias": jnp.asarray(c.bias.detach().numpy())}
        params[f"seq_{3 * i + 1}"] = {"bn": {
            "scale": jnp.asarray(b.weight.detach().numpy()),
            "bias": jnp.asarray(b.bias.detach().numpy())}}
        stats[f"seq_{3 * i + 1}"] = {"bn": {
            "mean": jnp.asarray(b.running_mean.numpy()),
            "var": jnp.asarray(b.running_var.numpy())}}
    flax = jax_blocks.ConvStack(stack.cins[0], 8, 7, len(stack.cins),
                                equivariant=False)
    out = flax.apply({"params": params, "batch_stats": stats},
                     jnp.asarray(x.permute(0, 2, 3, 1).numpy()), False)
    return np.asarray(out).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_kernel_c_launches_follow_the_jax_gate(name, monkeypatch):
    cfg = _cfg(name)
    want = jax_gate_launches(cfg, monkeypatch)
    fused = _seeded(PitchClassNet(cfg), 1)
    stacks = [m for m in fused.modules() if isinstance(m, ConvStack)
              and m.kernel is SK.CONV7 and m.fused_serving]
    assert want == sum(SK.CONV7.launches(s) for s in stacks)

    launched, inputs = [], []
    orig = CS.conv7_layer

    def counting(*a, **kw):
        launched.append(a[0].shape)
        return orig(*a, **kw)

    monkeypatch.setattr(CS, "conv7_layer", counting)
    hooks = [s.register_forward_pre_hook(
        lambda m, args: inputs.append((m, args[0]))) for s in stacks]
    mel = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, cfg.pitches, T, 1)).astype(np.float32))
    seq = torch.tensor([T, 57], dtype=torch.int32)
    with torch.no_grad():
        out_f = fused(mel, seq)
    for h in hooks:
        h.remove()
    assert len(launched) == want
    if not want:
        return

    # each stack the gate took, against the flax stack (bf16 numerics)
    for stack, x in inputs:
        with torch.no_grad():
            got = stack(x).numpy()
        ref = _flax_stack(stack, x)
        rel = np.abs(got - ref).max() / np.abs(ref).max()
        mean_rel = np.abs(got - ref).mean() / np.abs(ref).mean()
        assert rel < 5e-2 and mean_rel < 1e-2, (rel, mean_rel)

    # the whole model against the plain one (same weights)
    plain = PitchClassNet(cfg.replace(fused_convstack=False)).eval()
    plain.load_state_dict(fused.state_dict())
    with torch.no_grad():
        out_p = plain(mel, seq)
    assert float((out_f[0] - out_p[0]).abs().max()) < 3e-2
    rel = (out_f[1] - out_p[1]).abs().max() / out_p[1].abs().max()
    assert float(rel) < 3e-2, rel


# pcconv launches a served batch makes at the default widths where they
# are not 6 (two plain stacks of three convs): residual stacks are a stem
# and three blocks, three_layers' stacks one conv each and its layer-2
# stack (48 -> 64) too wide, dense stacks and the bf16 model none
PC_LAUNCHES = {"resblock": 14, "resblock_pc2p_mem": 14, "three_layers": 2,
               "denseblock": 0, "dense_p2pc_conv": 0, "bf16": 0}


@pytest.mark.parametrize("name", sorted(VARIANTS) + ["bf16"])
def test_chip_smoke_expects_the_jax_gate_at_full_width(name, monkeypatch):
    """chip_smoke.py serves every variant of the matrix and the bf16 model
    at the default Config's widths, and the kernel C launches it demands
    of each (chip_smoke.expected_launches) are the JAX gate's there; the
    residual conv kernel's are 7, the resblock variant's Pitch2Pitch
    stack (stem 5 -> 8), and none elsewhere (resblock_pc2p_mem's stem is
    4 -> 8); the pitch-class conv kernel's are one a conv of every float32
    pitch-class stack at its widths (PC_LAUNCHES)."""
    import types

    import chip_smoke
    from audio_key_estimation_torch.config import Config as PortConfig
    assert {k: v for k, v in chip_smoke.VARIANTS.items() if k != "bf16"} \
        == VARIANTS
    kw = chip_smoke.VARIANTS[name]
    est = types.SimpleNamespace(
        cfg=PortConfig(fused_convstack=True, **kw),
        model=PitchClassNet(PortConfig(fused_convstack=True, **kw)))
    want = jax_gate_launches(Config(fused_convstack=True, **kw), monkeypatch)
    assert chip_smoke.expected_launches(est) == {
        "cascade_pad": 7, "octave_response": 1, "conv7_layer": want,
        "resconv7": 7 if name == "resblock" else 0,
        "pcconv": PC_LAUNCHES.get(name, 6)}
