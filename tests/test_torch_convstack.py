"""PyTorch port: the fused serving ConvStack (kernel C) on the CPU.

Kernel C (ops/convstack_cuda.py) runs its plain PyTorch version here. In
float32 that version is the exact folded stack and must match the flax
ConvStack (eval mode) to 1e-4; in bf16 it carries the kernel's numerics
(bf16 operands and activations, f32 sums) and must match the JAX
package's fused Pallas stack (interpret mode) at that test's bars
(tests/test_convstack_pallas.py:86-103). The gate and the BN fold are
pinned too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_key_estimation_tpu.config import Config
from audio_key_estimation_tpu.models import blocks as jax_blocks
from audio_key_estimation_tpu.ops import convstack_pallas as CP

from audio_key_estimation_torch.models import PitchClassNet
from audio_key_estimation_torch.models.blocks import ConvStack
from audio_key_estimation_torch.ops import convstack_cuda as CS
from audio_key_estimation_torch.ops import stack_kernels as SK


def _rand_layers(rng, cins):
    """(w HWIO, bias, gamma, beta, mean, var) per layer, float32."""
    out = []
    for ci in cins:
        out.append((
            rng.standard_normal((7, 7, ci, 8)).astype(np.float32)
            * np.float32(0.5 / np.sqrt(49 * ci)),
            rng.standard_normal(8).astype(np.float32) * np.float32(0.1),
            (1.0 + 0.2 * rng.standard_normal(8)).astype(np.float32),
            (0.1 * rng.standard_normal(8)).astype(np.float32),
            (0.05 * rng.standard_normal(8)).astype(np.float32),
            (1.0 + 0.3 * rng.random(8)).astype(np.float32),
        ))
    return out


def _flax_stack(x_nhwc, layers, cin):
    stack = jax_blocks.ConvStack(cin, 8, 7, len(layers), equivariant=False)
    var = stack.init(jax.random.PRNGKey(0), jnp.asarray(x_nhwc[:1]), False)
    params = jax.tree_util.tree_map(lambda a: a, var["params"])
    bstats = jax.tree_util.tree_map(lambda a: a, var["batch_stats"])
    for i, (w, b, gamma, beta, mean, vvar) in enumerate(layers):
        params[f"seq_{3 * i}"]["kernel"] = jnp.asarray(w)
        params[f"seq_{3 * i}"]["bias"] = jnp.asarray(b)
        params[f"seq_{3 * i + 1}"]["bn"]["scale"] = jnp.asarray(gamma)
        params[f"seq_{3 * i + 1}"]["bn"]["bias"] = jnp.asarray(beta)
        bstats[f"seq_{3 * i + 1}"]["bn"]["mean"] = jnp.asarray(mean)
        bstats[f"seq_{3 * i + 1}"]["bn"]["var"] = jnp.asarray(vvar)
    return np.asarray(stack.apply(
        {"params": params, "batch_stats": bstats}, jnp.asarray(x_nhwc),
        False))


def _port_layers(layers):
    """Folded (OIHW weight, bias) tensors for the port's stack."""
    t = torch.from_numpy
    return [CS.fold_layer(t(w.transpose(3, 2, 0, 1).copy()), t(b), t(g),
                          t(be), t(m), t(v))
            for (w, b, g, be, m, v) in layers]


def _port_stack(x_nhwc, layers, dtype):
    """bf16: the serving stack (kernel C's plain version on the CPU);
    float32: the same plain layers without any bf16 rounding."""
    x = torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)
    if dtype == torch.bfloat16:
        y = CS.fused_convstack(x, _port_layers(layers))
    else:
        y = CS.fused_convstack_plain(x, _port_layers(layers), torch.float32)
    return y.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("cin,T", [(5, 23), (8, 17), (5, 9)])
def test_plain_stack_f32_matches_flax(rng, cin, T):
    x = rng.standard_normal((2, 10, T, cin)).astype(np.float32)
    layers = _rand_layers(rng, [cin, 8, 8])
    ref = _flax_stack(x, layers, cin)
    got = _port_stack(x, layers, torch.float32)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cin,T,chunk", [(5, 23, 8), (8, 24, 12),
                                         (5, 31, 16)])
def test_plain_stack_bf16_matches_pallas_interpret(cin, T, chunk):
    """The cases and bars of tests/test_convstack_pallas.py:86-103, with
    the JAX fused kernel (interpret mode) as the reference."""
    rng = np.random.default_rng(cin + T)
    B, H = 128, 8
    x = rng.standard_normal((B, H, T, cin)).astype(np.float32)
    layers = _rand_layers(rng, [cin, 8, 8])
    folded = [(w, b) + CP.fold_bn_affine(g, be, m, v)
              for (w, b, g, be, m, v) in layers]
    ref = np.asarray(CP.fused_convstack(jnp.asarray(x), folded, chunk=chunk,
                                        interpret=True), np.float32)
    got = _port_stack(x, layers, torch.bfloat16)
    assert got.shape == ref.shape
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    assert rel < 5e-2, rel
    mean_rel = np.abs(got - ref).mean() / np.abs(ref).mean()
    assert mean_rel < 1e-2, mean_rel
    # and against the f32 flax stack, as the JAX kernel is held
    flax_ref = _flax_stack(x, layers, cin)
    assert np.abs(got - flax_ref).max() / np.abs(flax_ref).max() < 5e-2


def test_fold_matches_jax_fold(rng):
    g, be, m = (rng.standard_normal(8).astype(np.float32) for _ in range(3))
    v = (0.5 + rng.random(8)).astype(np.float32)
    s_ref, t_ref = CP.fold_bn_affine(g, be, m, v)
    s, t = CS.fold_bn_affine(*(torch.from_numpy(a) for a in (g, be, m, v)))
    np.testing.assert_allclose(s.numpy(), s_ref, rtol=1e-6)
    np.testing.assert_allclose(t.numpy(), t_ref, rtol=1e-6, atol=1e-7)


def test_pack_weight_layout(rng):
    """Kernel C's weight operand: [dh][tap pair p][half][co][ci] =
    w[co, ci, dh, 2p + half], tap dt = 7 and the padded input channels
    zero; unpack_weight inverts it."""
    w = torch.from_numpy(rng.standard_normal((8, 5, 7, 7)).astype(np.float32))
    wp = CS.pack_weight(w)
    assert wp.shape == CS.PACKED == (7, 4, 2, 8, 8)
    for dh, dt, co, ci in [(0, 0, 0, 0), (3, 4, 7, 2), (6, 6, 5, 4)]:
        assert wp[dh, dt // 2, dt % 2, co, ci] == w[co, ci, dh, dt]
    assert not wp[:, 3, 1].any() and not wp[..., 5:].any()
    assert torch.equal(CS.unpack_weight(wp)[:, :5], w)
    assert not CS.unpack_weight(wp)[:, 5:].any()


def _stack_module(**kw):
    g = torch.Generator().manual_seed(0)
    args = dict(in_ch=5, out_ch=8, kernel_size=7, conv_layers=3,
                equivariant=False, generator=g, fused_serving=True)
    args.update(kw)
    return ConvStack(**args).eval()


@pytest.mark.parametrize("case,kw,shape,fused", [
    ("eligible", {}, (1, 5, 12, 6), True),
    ("t_below_3", {}, (1, 5, 12, 2), False),
    ("h_below_3", {}, (1, 5, 2, 6), False),
    ("kernel_5", dict(kernel_size=5), (1, 5, 12, 6), False),
    ("out_16", dict(out_ch=16), (1, 5, 12, 6), False),
    ("cin_9", dict(in_ch=9), (1, 9, 12, 6), False),
    ("flag_off", dict(fused_serving=False), (1, 5, 12, 6), False),
    ("any_batch", {}, (3, 5, 7, 6), True),
])
def test_gate(case, kw, shape, fused):
    stack = _stack_module(**kw)
    assert (stack.kernel is SK.CONV7
            and stack.runs_kernel(torch.zeros(shape))) is fused, case


def test_gate_off_in_train_mode():
    stack = _stack_module().train()
    assert stack.kernel is SK.CONV7
    assert stack.runs_kernel(torch.zeros(1, 5, 12, 6)) is False


def test_gate_output_matches_plain_stack(rng):
    """The gated (bf16 kernel-numerics) stack tracks the module's own
    float32 conv/BN/leaky path."""
    stack = _stack_module()
    with torch.no_grad():
        for bn in stack.layer[1::3]:
            bn.running_mean.copy_(torch.from_numpy(
                (0.1 * rng.standard_normal(8)).astype(np.float32)))
            bn.running_var.copy_(torch.from_numpy(
                (0.5 + rng.random(8)).astype(np.float32)))
        x = torch.from_numpy(rng.standard_normal((2, 5, 12, 9))
                             .astype(np.float32))
        fused = stack(x)
        stack.fused_serving = False
        plain = stack(x)
    rel = (fused - plain).abs().max() / plain.abs().max()
    assert fused.shape == plain.shape == (2, 8, 12, 9)
    assert rel < 5e-2, rel


def test_model_fused_gate_matches_plain(rng):
    """PitchClassNet with fused_convstack on (the serving configuration)
    against the plain model: key |d| < 3e-2
    (tests/test_convstack_pallas.py:180)."""
    cfg = Config(octaves=2, num_layers=2, conv_layers=3, n_filters=4,
                 kernel_size=7, head_layers=2)
    plain = PitchClassNet(cfg).eval()
    fused = PitchClassNet(cfg.replace(fused_convstack=True)).eval()
    fused.load_state_dict(plain.state_dict())
    assert fused.model[1].p2p.fused_serving
    mel = torch.from_numpy(rng.standard_normal((3, cfg.pitches, 40, 1))
                           .astype(np.float32))
    seq = torch.tensor([40, 33, 21], dtype=torch.int32)
    with torch.no_grad():
        assert fused.model[1].p2p.kernel is SK.CONV7
        assert fused.model[1].p2p.runs_kernel(
            torch.zeros(3, 5, cfg.pitches, 40))
        kf, tf = fused(mel, seq)
        kp, tp = plain(mel, seq)
    assert (kf - kp).abs().max() < 3e-2
    assert (tf - tp).abs().max() / tp.abs().max() < 3e-2
