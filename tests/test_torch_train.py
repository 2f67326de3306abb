"""PyTorch port: training against the JAX package on the CPU.

At the tiny geometry of tests/test_train.py (octaves=4, num_layers=2,
conv_layers=1, n_filters=2, kernel_size=3, head_layers=1, T = 32), with
the JAX model's weights carried across by `state_dict_from_jax`:
BatchNorm's training-mode statistics (flax's biased variance), one
`train_step` at acc_grad=2 (loss and gradients against JAX's
value_and_grad), three steps from a mid-run JAX state carried across with
`adam_state_from_jax` (parameters, batch_stats, Adam moments),
`evaluate`'s repeat-pad masking, dropout masks from an explicit
generator, remat, a checkpoint and resume round trip, and the CPU-only
refusal of CUDA. The JAX side's init and steps are jitted once per
process (`jax_side`): flax's eager init is slow on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_key_estimation_tpu.config import Config as JaxConfig
from audio_key_estimation_tpu.models import PitchClassNet as JaxNet
from audio_key_estimation_tpu.models.blocks import BatchNorm as JaxBatchNorm
from audio_key_estimation_tpu.train import trainer as jax_trainer
from audio_key_estimation_tpu.train.loss import compute_loss as jax_loss
from audio_key_estimation_tpu.train.optim import make_optimizer as jax_optim

from audio_key_estimation_torch.config import Config
from audio_key_estimation_torch.data.dataset import KeyDataset
from audio_key_estimation_torch.models import blocks
from audio_key_estimation_torch.models.convert import (
    adam_state_from_jax, load_adam_state, load_state_dict, match_names,
    state_dict_from_jax)
from audio_key_estimation_torch.train import checkpoints as ckpt_lib
from audio_key_estimation_torch.train import trainer
from audio_key_estimation_torch.utils.key_signatures import KEY_SIGNATURE_MAP

TINY = dict(octaves=4, num_layers=2, conv_layers=1, n_filters=2,
            kernel_size=3, head_layers=1, bucket_sizes=(32,), batch_size=4,
            acc_grad=2, frames=5)
STEPS_PER_EPOCH = 2
T = 32


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


@functools.lru_cache(maxsize=None)
def jax_side():
    """(cfg, flax model, initial TrainState as numpy, the jitted
    train_step, the jitted per-micro-batch value_and_grad)."""
    cfg = JaxConfig(**TINY)
    model = JaxNet(cfg)
    variables = jax.jit(lambda k, x: model.init(k, x, None, False))(
        jax.random.PRNGKey(0), jnp.zeros((1, cfg.pitches, 64, 1)))
    optimizer = jax_optim(cfg, STEPS_PER_EPOCH)
    state = jax_trainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=optimizer.init(variables["params"]))
    step = jax_trainer.make_train_step(model, cfg, optimizer, seed=0)

    def loss_fn(params, batch_stats, micro):
        outputs, new_bs = jax_trainer._forward(model, cfg, params,
                                               batch_stats, micro, True)
        loss, _ = jax_loss(cfg, outputs, micro)
        return loss, new_bs

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    return cfg, model, _np(state), step, grad_fn


def _batch(rng, acc=2, bs=4, t=T):
    """One stacked (acc, bs, ...) training batch; some samples shorter
    than the padded length."""
    cfg = Config(**TINY)
    seq = rng.integers(t // 2, t + 1, (acc, bs)).astype(np.int32)
    mel = rng.normal(size=(acc, bs, cfg.pitches, t, 1)).astype(np.float32)
    mel *= (np.arange(t) < seq[..., None])[:, :, None, :, None]
    return {"mel": mel, "seq_length": seq,
            "key_labels": np.eye(12, dtype=np.float32)[
                rng.integers(0, 12, (acc, bs))],
            "tonic_labels": np.eye(12, dtype=np.float32)[
                rng.integers(0, 12, (acc, bs))],
            "genre": np.zeros((acc, bs, 11), np.float32)}


def _port_state(jstate, cfg=None, adam=False):
    """The port's TrainState on the CPU from a (numpy) JAX TrainState."""
    cfg = cfg or Config(**TINY)
    state = trainer.create_train_state(cfg, 0, "cpu")
    load_state_dict(state.model, state_dict_from_jax(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    if adam:
        load_adam_state(state.optimizer, state.model,
                        adam_state_from_jax(jstate.opt_state))
        state.step = int(jstate.step)
    return state


def _port_tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _by_port_name(named, exported):
    """{port name of `named` (parameters or buffers): exported array}."""
    names = match_names(dict(named), exported)
    return {k: exported[v] for k, v in names.items()}


# ---------------------------------------------------------------------------
# BatchNorm and dropout
# ---------------------------------------------------------------------------

def test_batchnorm_training_statistics_match_flax(rng):
    """One training-mode call on (2, 6, 5, 3) NHWC (n = 60 per channel):
    the port's running statistics equal flax's batch_stats at rtol 1e-6
    (the biased batch variance, momentum 0.1), the output at 1e-5; eval
    mode still normalizes with the running statistics."""
    x = (rng.normal(size=(2, 6, 5, 3)) * [1.0, 0.5, 2.0] + [0.3, -1.0, 4.0]
         ).astype(np.float32)
    bn = JaxBatchNorm(3)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x), False)
    y_j, mutated = bn.apply(variables, jnp.asarray(x), True,
                            mutable=["batch_stats"])
    stats = mutated["batch_stats"]["bn"]
    ours = blocks.BatchNorm(3).train()
    y_t = ours(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(ours.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-6)
    np.testing.assert_allclose(ours.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(y_t.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(y_j), rtol=1e-5, atol=1e-5)
    ours.eval()
    y_e = ours(torch.from_numpy(x).permute(0, 3, 1, 2))
    y_je = bn.apply({"params": variables["params"],
                     "batch_stats": mutated["batch_stats"]},
                    jnp.asarray(x), False)
    np.testing.assert_allclose(y_e.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(y_je), rtol=1e-5, atol=1e-5)


def test_dropout_masks_come_from_the_generator():
    """The same seed gives the same mask, another seed another; the kept
    share lies within 5 binomial standard deviations of 1 - rate; kept
    elements are scaled by 1 / (1 - rate); without a generator it
    raises."""
    x = torch.ones(200_000)
    rate = 0.3
    gen = torch.Generator()
    a = blocks.dropout(x, rate, gen.manual_seed(11))
    b = blocks.dropout(x, rate, gen.manual_seed(11))
    c = blocks.dropout(x, rate, gen.manual_seed(12))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = int((a != 0).sum())
    n, p = x.numel(), 1 - rate
    assert abs(kept - n * p) <= 5 * np.sqrt(n * p * (1 - p)), kept
    np.testing.assert_allclose(a[a != 0].numpy(), 1 / p, rtol=1e-6)
    with pytest.raises(RuntimeError, match="generator"):
        blocks.dropout(x, rate, None)


# ---------------------------------------------------------------------------
# train_step against JAX
# ---------------------------------------------------------------------------

def _grads_jax(s0, batch):
    """JAX's averaged value_and_grad over the micro-batches from state
    s0, the BatchNorm statistics carried from one to the next."""
    grad_fn = jax_side()[4]
    bs = s0.batch_stats
    losses, total = [], None
    for i in range(batch["mel"].shape[0]):
        micro = {k: v[i] for k, v in batch.items()}
        (loss, bs), g = grad_fn(s0.params, bs, micro)
        losses.append(float(loss))
        total = g if total is None else jax.tree_util.tree_map(jnp.add,
                                                               total, g)
    grads = jax.tree_util.tree_map(lambda g: np.asarray(g) / len(losses),
                                   total)
    return float(np.mean(losses)), grads, _np(bs)


def assert_close_to_scale(got: dict, want: dict, rtol: float,
                          floor: float) -> None:
    """Each tensor within rtol of its own largest magnitude plus `floor`
    of the largest magnitude over all of them."""
    top = max(float(np.abs(v).max()) for v in want.values())
    for k, v in want.items():
        d = float(np.abs(got[k] - v).max())
        assert d <= rtol * float(np.abs(v).max()) + floor * top, (k, d)


def test_train_step_loss_and_gradients_match_jax(rng):
    """One train_step at acc_grad=2 from the JAX model's initial weights:
    loss at rtol 1e-5; each gradient within 1e-4 of its tensor's largest
    magnitude plus 1e-5 of the model's largest gradient (float32 through
    two frameworks' convolutions: rounding follows the magnitude of the
    terms summed, so a gradient that cancels to ~0, as a conv bias ahead
    of a training-mode BatchNorm does, keeps the model's rounding floor);
    BatchNorm running statistics after both micro-batches at rtol 1e-5."""
    _, _, s0, _, _ = jax_side()
    batch = _batch(rng)
    loss_j, grads_j, bs_j = _grads_jax(s0, batch)
    state = _port_state(s0)
    step = trainer.make_train_step(Config(**TINY), STEPS_PER_EPOCH, seed=0)
    loss_t = float(step(state, _port_tensors(batch))["loss"])
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    want = _by_port_name(state.model.named_parameters(), state_dict_from_jax(
        {"params": grads_j}))
    params = dict(state.model.named_parameters())
    assert want.keys() == params.keys()
    assert_close_to_scale({k: p.grad.numpy() for k, p in params.items()},
                          want, 1e-4, 1e-5)
    stats = _by_port_name(state.model.named_buffers(), state_dict_from_jax(
        {"batch_stats": bs_j}))
    buffers = dict(state.model.named_buffers())
    for k, v in stats.items():
        np.testing.assert_allclose(buffers[k].numpy(), v, rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert state.step == 1


def test_three_steps_from_a_jax_state_match(rng):
    """Two JAX steps give a mid-run state (Adam moments and count); the
    port takes it over through state_dict_from_jax and adam_state_from_jax
    and both sides take three more steps on the same batches. Bars: the
    step losses at rtol 1e-5; batch_stats at rtol 1e-5 (running means
    also within the floor parameters' bar below, which a floor bias adds
    to the batch means of the BatchNorm after it); Adam's moments as
    the gradients' bar (1e-4 of the tensor's largest magnitude plus 1e-5
    of the model's largest). A parameter moves lr * m / (sqrt(v) + eps) a
    step, about lr at most, so parameters are held to 1e-3 * lr, except
    those whose gradient sits at the rounding floor (largest JAX gradient
    magnitude below 1e-5 of the model's: conv biases ahead of a
    training-mode BatchNorm, the tonic head's bias under the softmax):
    Adam scales their rounding noise to steps of ~lr on either side, so
    they are held to 2 * lr a step."""
    cfg_j, _, s0, step_j, _ = jax_side()
    batches = [_batch(rng) for _ in range(5)]
    s = jax.tree_util.tree_map(jnp.asarray, s0)
    for b in batches[:2]:
        s, _ = step_j(s, b)
    mid = _np(s)
    state = _port_state(mid, adam=True)
    assert state.step == 2
    model = state.model
    floor = _rounding_floor(model, _grads_jax(mid, batches[2])[1])
    step_t = trainer.make_train_step(Config(**TINY), STEPS_PER_EPOCH, seed=0)
    s = jax.tree_util.tree_map(jnp.asarray, mid)
    for b in batches[2:]:
        s, m_j = step_j(s, b)
        m_t = step_t(state, _port_tensors(b))
        np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                                   rtol=1e-5)
    end = _np(s)
    assert state.step == int(end.step) == 5
    lr = cfg_j.lr
    params = dict(model.named_parameters())
    want = _by_port_name(model.named_parameters(),
                         state_dict_from_jax({"params": end.params}))
    for k, v in want.items():
        d = np.abs(params[k].detach().numpy() - v).max()
        assert d <= (2 * lr * 3 if k in floor else 1e-3 * lr), (k, d)
    stats = _by_port_name(model.named_buffers(), state_dict_from_jax(
        {"batch_stats": end.batch_stats}))
    buffers = dict(model.named_buffers())
    for k, v in stats.items():
        # a floor bias shifts the batch means its BatchNorm averages in
        np.testing.assert_allclose(
            buffers[k].numpy(), v, rtol=1e-5,
            atol=2 * lr * 3 if k.endswith("mean") else 1e-6, err_msg=k)
    moments = _by_port_name(model.named_parameters(),
                            adam_state_from_jax(end.opt_state))
    for name in ("exp_avg", "exp_avg_sq"):
        assert_close_to_scale(
            {k: state.optimizer.state[params[k]][name].numpy()
             for k in moments}, {k: st[name] for k, st in moments.items()},
            1e-4, 1e-5)
    for k, st in moments.items():
        assert float(state.optimizer.state[params[k]]["step"]) \
            == float(st["step"]) == 5


def _rounding_floor(model, grads) -> set:
    """Port names of the parameters whose (JAX) gradient lies below 1e-5
    of the model's largest gradient magnitude."""
    g = _by_port_name(model.named_parameters(),
                      state_dict_from_jax({"params": grads}))
    top = max(float(np.abs(v).max()) for v in g.values())
    floor = {k for k, v in g.items() if np.abs(v).max() <= 1e-5 * top}
    assert floor, "expected gradients at the rounding floor"
    return floor


# ---------------------------------------------------------------------------
# evaluate
# ---------------------------------------------------------------------------

def _dataset(rng, n, cfg=None, t_max=T):
    """A KeyDataset of n random songs (mel, labels) on the CPU."""
    cfg = cfg or Config(**TINY)
    ds = KeyDataset(False, cfg, blacklist_path="", device="cpu")
    for i in range(n):
        t = int(rng.integers(t_max // 2, t_max + 1))
        row = int(rng.integers(0, 21))
        sig = np.zeros(24, np.float32)
        sig[int(rng.integers(0, 24))] = 1
        ds.items.append({
            "file": f"s{i}", "dataset": "synthetic",
            "mel": rng.normal(size=(cfg.pitches, t)).astype(np.float32),
            "key_labels": KEY_SIGNATURE_MAP[row].astype(np.float32),
            "key_signature_id": sig,
            "tonic_labels": np.eye(12, dtype=np.float32)[
                int(rng.integers(0, 12))],
            "genre": np.zeros(11, np.float32), "seq_length": np.int32(t)})
    return ds


def test_evaluate_masks_repeat_padding_and_matches_jax(rng):
    """Five songs at batch size 4 (the tail batch repeat-padded with its
    last song) score as five songs at batch sizes 5 and 1, and as the
    JAX package's evaluate on the same weights and batches (loss at rtol
    1e-5; categories exact, averages at float32 rounding)."""
    cfg_j, model_j, s0, _, _ = jax_side()
    ds = _dataset(rng, 5)
    state = _port_state(s0)
    step = trainer.make_eval_step(Config(**TINY))
    runs = {bs: trainer.evaluate(step, state, ds, bs) for bs in (4, 5, 1)}
    for bs in (5, 1):
        for k, v in runs[4].items():
            np.testing.assert_allclose(runs[bs][k], v, rtol=1e-6, err_msg=k)
    assert runs[4]["num_samples"] == 5
    ref = jax_trainer.evaluate(jax_trainer.make_eval_step(model_j, cfg_j),
                               jax.tree_util.tree_map(jnp.asarray, s0), ds,
                               4)
    assert runs[4].keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_allclose(runs[4][k], v, rtol=1e-5, atol=1e-7,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the Trainer: dropout, remat, checkpoints, resume, device
# ---------------------------------------------------------------------------

DENSE = dict(TINY, denseblock=True, drop=0.3)


def _weights(state):
    return {k: v.detach().clone() for k, v in
            state.model.state_dict().items()}


def test_dropout_training_is_seeded(rng):
    """Dropout (dense blocks, drop 0.3) through train_step: the same fit
    seed gives the same run, another seed another; drop 0 makes the seed
    irrelevant."""
    cfg = Config(**DENSE)
    batch = _port_tensors(_batch(rng))

    def run(seed, cfg=cfg):
        state = trainer.create_train_state(cfg, 0, "cpu")
        step = trainer.make_train_step(cfg, STEPS_PER_EPOCH, seed=seed)
        losses = [float(step(state, batch)["loss"]) for _ in range(2)]
        return losses, _weights(state)

    (l1, w1), (l2, w2), (l3, w3) = run(1), run(1), run(2)
    assert l1 == l2 and all(torch.equal(w1[k], w2[k]) for k in w1)
    assert l1 != l3
    off = cfg.replace(drop=0.0)
    assert run(1, off)[0] == run(2, off)[0]


def test_remat_matches_plain_training(rng):
    """cfg.remat recomputes each trunk layer in the backward pass: with
    dropout on, the gradients equal the plain step's (the same masks are
    drawn again) and each BatchNorm's running statistics are updated once
    per forward, not again by the recomputation."""
    batch = _port_tensors(_batch(rng))
    out = {}
    for remat in (False, True):
        cfg = Config(**DENSE, remat=remat)
        state = trainer.create_train_state(cfg, 0, "cpu")
        step = trainer.make_train_step(cfg, STEPS_PER_EPOCH, seed=3)
        loss = float(step(state, batch)["loss"])
        grads = {k: p.grad.clone() for k, p in
                 state.model.named_parameters()}
        out[remat] = loss, grads, dict(state.model.named_buffers())
    assert out[True][0] == out[False][0]
    for k, g in out[False][1].items():
        torch.testing.assert_close(out[True][1][k], g, rtol=1e-6,
                                   atol=1e-9)
    for k, b in out[False][2].items():
        torch.testing.assert_close(out[True][2][k], b, rtol=0, atol=0)


def test_fit_checkpoint_and_resume_round_trip(rng, tmp_path):
    """fit writes best_model.pt, last_state.pt and config.json; the best
    checkpoint loads into a fresh model and evaluates as the epoch that
    saved it; a run stopped after 2 of 3 epochs and resumed ends with the
    weights, optimizer state and step of an uninterrupted 3-epoch run."""
    cfg = Config(**TINY, epochs=3, early_stop_patience=5)
    train, val = _dataset(rng, 16), _dataset(rng, 6)
    full = trainer.Trainer(cfg, train, val, log_dir=str(tmp_path / "full"),
                           device="cpu")
    s_full, hist = full.fit(seed=0, eval_at_start=True)
    assert [r["epoch"] for r in hist] == [-1, 0, 1, 2]
    run = tmp_path / "full"
    assert {p.name for p in run.iterdir()} >= {"best_model.pt",
                                                "last_state.pt",
                                                "config.json"}
    sd, saved_cfg = ckpt_lib.load(str(run))
    assert saved_cfg == cfg
    best = max(hist[1:], key=lambda r: r["val_mirex"])
    fresh = trainer.create_train_state(saved_cfg, 5, "cpu")
    fresh.model.load_state_dict(sd)
    got = trainer.evaluate(trainer.make_eval_step(cfg), fresh, val,
                           cfg.batch_size)
    assert got["mirex"] == best["val_mirex"]

    part = trainer.Trainer(cfg.replace(epochs=2), train, val,
                           log_dir=str(tmp_path / "part"), device="cpu")
    part.fit(seed=0)
    resumed = trainer.Trainer(cfg, train, val,
                              log_dir=str(tmp_path / "part"), device="cpu")
    s_res, hist_res = resumed.fit(seed=0, resume=True)
    assert [r["epoch"] for r in hist_res] == [2]
    assert s_res.step == s_full.step == 3 * (16 // 8)
    for k, v in s_full.model.state_dict().items():
        assert torch.equal(s_res.model.state_dict()[k], v), k
    a = s_full.optimizer.state_dict()["state"]
    b = s_res.optimizer.state_dict()["state"]
    for i in a:
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a[i][name], b[i][name]), (i, name)
    np.testing.assert_array_equal(hist_res[0]["val_loss"],
                                  hist[-1]["val_loss"])


def test_jax_run_directories_raise(tmp_path):
    """An orbax best_model/ or a JAX last_state.msgpack names the
    conversion instead of failing to unpickle."""
    (tmp_path / "best_model").mkdir()
    (tmp_path / "last_state.msgpack").write_bytes(b"\x80")
    with pytest.raises(ValueError, match="state_dict_from_jax"):
        ckpt_lib.load(str(tmp_path))
    with pytest.raises(ValueError, match="state_dict_from_jax"):
        ckpt_lib.has_train_state(str(tmp_path))
    assert not ckpt_lib.has_train_state(str(tmp_path / "nothing"))


@pytest.mark.parametrize("kw", [{}, {"device": "cuda"}],
                         ids=["default", "cuda"])
def test_trainer_refuses_cuda_without_cuda(kw, rng):
    """The Trainer and create_train_state run on the card by default;
    without CUDA they raise unless the CPU is asked for."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    cfg = Config(**TINY)
    ds = _dataset(rng, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        trainer.Trainer(cfg, ds, ds, **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        trainer.create_train_state(cfg, 0, **kw)
    assert trainer.Trainer(cfg, ds, ds, device="cpu").device.type == "cpu"


def test_multi_scale_raises():
    """A multi-scale Config trains the ensemble: the Trainer accepts it and
    create_train_state builds PitchClassNetMulti (Adam over both towers
    and nothing else); only PitchClassNet itself raises for it, naming
    the ensemble."""
    from audio_key_estimation_torch.models import (PitchClassNet,
                                                   PitchClassNetMulti)
    cfg = Config(**TINY, multi_scale=True)
    assert trainer.Trainer(cfg, [], [], device="cpu").cfg.multi_scale
    state = trainer.create_train_state(cfg, 0, "cpu")
    assert isinstance(state.model, PitchClassNetMulti)
    n = sum(p.numel() for p in state.model.parameters())
    assert n == sum(p.numel() for g in state.optimizer.param_groups
                    for p in g["params"])
    with pytest.raises(ValueError, match="PitchClassNetMulti"):
        PitchClassNet(cfg)
