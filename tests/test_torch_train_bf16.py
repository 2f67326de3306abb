"""PyTorch port: one bf16 train step against the JAX trainer's bf16 step.

The geometry of tests/test_torch_train.py at one layer (TINY with
num_layers=1) and `dtype="bfloat16"` (float32 weights and Adam, bf16
compute), the JAX model's initial weights carried across by
`models/convert.py`, three seeded batches whose samples carry their
labels (triad_batch): one `train_step` at acc_grad=2 against the JAX
trainer's bf16 loss over the same micro-batches. This is the path the
bf16 convergence run (`scripts/train_converge_hard.py` with
AKX_DTYPE=bfloat16) trains through.

The reference is the JAX trainer's bf16 loss (`_forward` and
`compute_loss`), evaluated op by op, so that every operation rounds its
result to bf16 as the port's eager PyTorch does (under jit, XLA may keep
a fused chain in float32: xla_allow_excess_precision):
 * the loss and the BatchNorm statistics: value_and_grad over the
   micro-batches, the statistics carried from one to the next (the JAX
   trainer's step);
 * the gradients: the same loss differentiated by JAX in forward mode
   (jax.jacfwd over the flattened parameters). XLA on the CPU sums a
   bf16 reverse-mode reduction (a bias's gradient, the transpose of its
   broadcast) in a bf16 accumulator, which moves the head bias's gradient
   by a large share of its size; forward mode, like the TPU, sums in
   float32.

Bars, from bf16's unit roundoff u = 2^-8 (8 significant bits):
 * the loss within rtol u (one rounding of the loss itself);
 * every gradient within 4u of that tensor's largest magnitude (a few
   roundings of u/2 on either side; the issue's cap is 5e-2);
 * except where the exact gradient is 0: a tensor whose float32 gradient
   (JAX's step at dtype float32) stays below u/16 of the model's largest
   gradient holds only rounding noise, and is held to u/2 of the model's
   largest gradient (one rounding of a term of that size). These are the
   tonic head's bias (a shift under its softmax), the biases ahead of a
   training-mode BatchNorm and the first BatchNorm's scale (the next
   BatchNorm removes a shift or a scale): float32 leaves them within
   1e-4 of the largest, every other tensor lies above 1e-2 of it;
 * every BatchNorm running statistic within u/8 of that tensor's largest
   magnitude: float32 statistics of bf16 activations that the two
   frameworks round alike but for a conv's summation order, where one
   bf16 rounding of the weights (u/2) would show;
 * the bars see the dtype: the port's float32 step misses the bf16
   reference, on a gradient and on a statistic.

One layer, because at two the bf16 step is chaotic: the rare one-ulp
differences that the frameworks' summation orders leave in a conv's
output spread through the next BatchNorms and move the first layer's
gradients by more than 5e-2 of their size. The port's conv biases and
BatchNorms round where the JAX model's do (ops/
equivariant.conv_with_bias, blocks.BatchNorm), so at one layer the two
forwards agree but for those summation orders.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.flatten_util import ravel_pytree

from audio_key_estimation_tpu.config import Config as JaxConfig
from audio_key_estimation_tpu.models import PitchClassNet as JaxNet
from audio_key_estimation_tpu.train import trainer as jax_trainer
from audio_key_estimation_tpu.train.loss import compute_loss as jax_loss

from audio_key_estimation_torch.config import Config
from audio_key_estimation_torch.models.convert import (load_state_dict,
                                                       state_dict_from_jax)
from audio_key_estimation_torch.train import trainer

from test_torch_train import (STEPS_PER_EPOCH, T, TINY, _by_port_name, _np,
                              _port_tensors)

U = 2.0 ** -8             # bf16 unit roundoff
GRAD_RTOL = 4 * U
ZERO = U / 16             # float32 gradient below this share: exactly 0
ZERO_ATOL = U / 2
STATS_RTOL = U / 8
GEOMETRY = dict(TINY, num_layers=1)
SEEDS = [0, 1, 2]


def triad_batch(rng, noise=0.3, acc=2, bs=4, t=T):
    """One stacked (acc, bs, ...) training batch whose samples carry their
    labels: sample key k lights the rows of the major triad on k (1.0,
    every other row 0.1) under |N(0, noise)| frames, tonic and key label
    k; some samples shorter than the padded length."""
    cfg = Config(**GEOMETRY)
    keys = rng.integers(0, 12, (acc, bs))
    seq = rng.integers(t // 2, t + 1, (acc, bs)).astype(np.int32)
    pc = (np.arange(cfg.pitches) // 3) % 12          # 3 bins a semitone
    lit = (pc[None, None] - keys[..., None]) % 12
    mel = np.where(np.isin(lit, (0, 4, 7)), 1.0, 0.1)[..., None, None] \
        + noise * np.abs(rng.normal(size=(acc, bs, cfg.pitches, t, 1)))
    mel = (mel * (np.arange(t) < seq[..., None])[:, :, None, :, None]
           ).astype(np.float32)
    onehot = np.eye(12, dtype=np.float32)[keys]
    return {"mel": mel, "seq_length": seq, "key_labels": onehot,
            "tonic_labels": onehot,
            "genre": np.zeros((acc, bs, 11), np.float32)}


@functools.lru_cache(maxsize=None)
def jax_side(dtype: str):
    """(initial variables as numpy, per-micro-batch value_and_grad,
    per-micro-batch forward-mode gradient over the flattened parameters,
    the flattened initial parameters, their unflatten) of the one-layer
    model at `dtype`, op by op; the initial weights do not depend on the
    compute dtype (float32 parameters)."""
    cfg = JaxConfig(**GEOMETRY, dtype=dtype)
    model = JaxNet(cfg)
    variables = jax.jit(lambda k, x: model.init(k, x, None, False))(
        jax.random.PRNGKey(0), jnp.zeros((1, cfg.pitches, 64, 1)))

    def loss_fn(params, batch_stats, micro):
        outputs, new_bs = jax_trainer._forward(model, cfg, params,
                                               batch_stats, micro, True)
        loss, _ = jax_loss(cfg, outputs, micro)
        return loss, new_bs

    flat, unravel = ravel_pytree(variables["params"])
    # training-mode BatchNorm normalizes by the batch's own statistics,
    # so the loss does not depend on the incoming running statistics
    forward_grad = jax.jacfwd(lambda theta, micro: loss_fn(
        unravel(theta), variables["batch_stats"], micro)[0])
    return (_np(variables), jax.value_and_grad(loss_fn, has_aux=True),
            forward_grad, flat, unravel)


@functools.lru_cache(maxsize=None)
def reference(seed: int):
    """The batch, and the JAX side at each dtype: the step's mean micro
    loss, its BatchNorm statistics after every micro-batch and its
    averaged gradients; at bf16 also the forward-mode averaged gradients;
    as float32 numpy."""
    batch = triad_batch(np.random.default_rng(seed))
    out = {"batch": batch}
    for dtype in ("bfloat16", "float32"):
        variables, grad_fn, forward_grad, flat, unravel = jax_side(dtype)
        bs = variables["batch_stats"]
        losses, total, fwd = [], None, 0.0
        for i in range(batch["mel"].shape[0]):
            micro = {k: v[i] for k, v in batch.items()}
            (loss, bs), g = grad_fn(variables["params"], bs, micro)
            losses.append(float(loss))
            total = g if total is None else jax.tree_util.tree_map(
                jnp.add, total, g)
            if dtype == "bfloat16":
                fwd = fwd + np.asarray(forward_grad(flat, micro), np.float64)
        n = len(losses)
        out[dtype] = {
            "loss": float(np.mean(losses)), "stats": _np(bs),
            "grads": jax.tree_util.tree_map(
                lambda g: np.asarray(g, np.float32) / n, total)}
        if dtype == "bfloat16":
            out[dtype]["forward"] = _np(unravel(
                jnp.asarray((fwd / n).astype(np.float32))))
    return out


def port_step(seed: int, dtype: str):
    """The port's TrainState after one train_step at `dtype` from the JAX
    model's initial weights, and the step's loss."""
    ref = reference(seed)
    cfg = Config(**GEOMETRY, dtype=dtype)
    state = trainer.create_train_state(cfg, 0, "cpu")
    load_state_dict(state.model, state_dict_from_jax(jax_side(dtype)[0]))
    step = trainer.make_train_step(cfg, STEPS_PER_EPOCH, seed=0)
    loss = float(step(state, _port_tensors(ref["batch"]))["loss"])
    assert state.step == 1
    return state, loss


def gradient_misses(seed: int, state) -> list:
    """Each parameter whose gradient is off the forward-mode bf16
    reference by more than its bar, as (name, distance, bar)."""
    ref = reference(seed)
    by_name = lambda g: _by_port_name(state.model.named_parameters(),
                                      state_dict_from_jax({"params": g}))
    want = by_name(ref["bfloat16"]["forward"])
    exact = by_name(ref["float32"]["grads"])
    params = dict(state.model.named_parameters())
    assert want.keys() == params.keys() == exact.keys()
    top = max(float(np.abs(v).max()) for v in exact.values())
    misses = []
    for k, p in params.items():
        got = p.grad.numpy()
        assert got.dtype == np.float32, (k, got.dtype)
        d = float(np.abs(got - want[k]).max())
        bar = (ZERO_ATOL * top if float(np.abs(exact[k]).max()) < ZERO * top
               else GRAD_RTOL * float(np.abs(want[k]).max()))
        if d > bar:
            misses.append((k, d, bar))
    return misses


def statistic_misses(seed: int, state) -> list:
    """Each BatchNorm running statistic off the JAX bf16 step's by more
    than STATS_RTOL of its largest magnitude, as (name, distance, bar)."""
    stats = _by_port_name(state.model.named_buffers(), state_dict_from_jax(
        {"batch_stats": reference(seed)["bfloat16"]["stats"]}))
    buffers = dict(state.model.named_buffers())
    assert stats.keys() == buffers.keys()
    misses = []
    for k, v in stats.items():
        d = float(np.abs(buffers[k].numpy() - v).max())
        bar = STATS_RTOL * float(np.abs(v).max())
        if d > bar:
            misses.append((k, d, bar))
    return misses


@pytest.mark.parametrize("seed", SEEDS)
def test_bf16_train_step_matches_jax(seed):
    state, loss = port_step(seed, "bfloat16")
    np.testing.assert_allclose(loss, reference(seed)["bfloat16"]["loss"],
                               rtol=U)
    assert not gradient_misses(seed, state)
    assert not statistic_misses(seed, state)


@pytest.mark.parametrize("seed", SEEDS)
def test_float32_step_misses_the_bf16_reference(seed):
    """The bars above see the compute dtype: a float32 step from the same
    weights on the same batch lands off the bf16 reference on a gradient
    and on a BatchNorm statistic, so a bf16 step that silently ran in
    float32 would fail."""
    state, _ = port_step(seed, "float32")
    assert gradient_misses(seed, state), "float32 met every gradient bar"
    assert statistic_misses(seed, state), "float32 met every statistic bar"
