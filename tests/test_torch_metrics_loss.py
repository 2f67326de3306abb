"""PyTorch port: MIREX metrics, the multi-task loss and the optimizer
against the JAX package's train/metrics.py, train/loss.py and
train/optim.py on the same inputs.

Per-sample metrics are exact (the same argmaxes on the same float32
inputs; batch means within float32 summation-order rounding); the
loss holds at rtol 1e-5 (float32, the same formula: BCE on the sigmoid
clipped at 1e-7, log-softmax cross entropy); the optimizer holds against
optax at 1e-9 in float64 over 3 epochs x 3 steps (the bar of
tests/test_train.py::test_optimizer_matches_torch_adam_exponential_lr).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audio_key_estimation_tpu.config import Config as JaxConfig
from audio_key_estimation_tpu.train import loss as jax_loss
from audio_key_estimation_tpu.train import metrics as jax_metrics
from audio_key_estimation_tpu.train.optim import make_optimizer as jax_optim
from audio_key_estimation_tpu.utils.key_signatures import KEY_SIGNATURE_MAP

from audio_key_estimation_torch.config import Config
from audio_key_estimation_torch.train import loss, metrics, optim

CATEGORIES = ("correct", "fifths", "relative", "parallel", "other",
              "accuracy", "mirex")


def _metric_inputs(rng, lead):
    """key sigmoids, KEY_SIGNATURE_MAP rows as labels (some the predicted
    rows themselves, so every category occurs), one-hot tonics and
    24-slot signature ids (some all-zero: the flat-spelling quirk)."""
    n = int(np.prod(lead))
    rows = rng.integers(0, 21, n)
    key_preds = rng.uniform(0, 1, (n, 12)).astype(np.float32)
    near = rng.random(n) < 0.5
    key_preds[near] = (0.8 * KEY_SIGNATURE_MAP[rows[near]]
                       + 0.2 * key_preds[near])
    key_labels = KEY_SIGNATURE_MAP[rows].astype(np.float32)
    tonic_idx = rng.integers(0, 12, n)
    tonic_labels = np.eye(12, dtype=np.float32)[tonic_idx]
    tonic_preds = rng.normal(size=(n, 12)).astype(np.float32)
    tonic_preds[::3, tonic_idx[::3]] += 5.0
    sig = np.zeros((n, 24), np.float32)
    sig[np.arange(n), np.clip(rows + rng.integers(-1, 2, n), 0, 23)] = 1
    sig[:max(n // 10, 1)] = 0
    arrs = (key_labels, key_preds, tonic_labels, tonic_preds, sig)
    return [a.reshape(lead + a.shape[1:]) for a in arrs]


@pytest.mark.parametrize("lead", [(64,), (6, 11)], ids=["global", "local"])
def test_mirex_categories_exact(rng, lead):
    """Per-sample categories equal the JAX package's exactly, for a batch
    and for (batch, windows); the batch score within float32 rounding."""
    args = _metric_inputs(rng, lead)
    ours = metrics.mirex_categories(*map(torch.from_numpy, args))
    ref = jax_metrics.mirex_categories(*map(jnp.asarray, args))
    for k in CATEGORIES:
        assert ours[k].shape == lead and ours[k].dtype == torch.float32
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    assert sum(float(ours[k].sum()) for k in CATEGORIES[:5]) == np.prod(lead)
    for k in CATEGORIES[:4]:
        assert float(ours[k].sum()) > 0, f"no {k} sample: weak inputs"
    # the batch means: float32 sums in another order, rtol 1e-6
    score = metrics.mirex_score(*map(torch.from_numpy, args))
    ref_score = jax_metrics.mirex_score(*map(jnp.asarray, args))
    for k in CATEGORIES:
        np.testing.assert_allclose(float(score[k]), float(ref_score[k]),
                                   rtol=1e-6, err_msg=k)


def test_accuracies_exact(rng):
    n = 40
    key_preds = rng.uniform(0, 1, (n, 12)).astype(np.float32)
    key_preds[:4, :8] = 0.5                          # ties at the 7th value
    key_labels = (key_preds >= np.sort(key_preds, 1)[:, -7:-6]
                  ).astype(np.float32)
    key_labels[::2] = KEY_SIGNATURE_MAP[rng.integers(0, 21, n // 2)]
    tonic_idx = rng.integers(0, 12, n)
    tonic_preds = rng.normal(size=(n, 12)).astype(np.float32)
    genre_idx = rng.integers(0, 11, n)
    genre_preds = rng.normal(size=(n, 11)).astype(np.float32)
    mask = rng.random(n) < 0.5
    t = torch.from_numpy
    assert float(metrics.all_key_accuracy(t(key_labels), t(key_preds))) \
        == float(jax_metrics.all_key_accuracy(jnp.asarray(key_labels),
                                              jnp.asarray(key_preds)))
    assert float(metrics.tonic_accuracy(t(tonic_idx), t(tonic_preds))) \
        == float(jax_metrics.tonic_accuracy(jnp.asarray(tonic_idx),
                                            jnp.asarray(tonic_preds)))
    for m in (mask, np.zeros(n, bool)):
        got = float(metrics.genre_accuracy(t(genre_idx), t(genre_preds),
                                           t(m)))
        want = float(jax_metrics.genre_accuracy(
            jnp.asarray(genre_idx), jnp.asarray(genre_preds),
            jnp.asarray(m)))
        assert got == want
    assert got == 0.0                          # no labeled sample


# ---------------------------------------------------------------------------
# compute_loss
# ---------------------------------------------------------------------------

LOSS_CASES = {
    "global": dict(),
    "global_genre_cos": dict(genre=True, use_cos=True, genre_weight=0.3),
    "local": dict(local=True),
    "local_straddle": dict(local=True, straddle_weight=0.25),
    "local_straddle_zero": dict(local=True, straddle_weight=0.0),
    "local_genre_cos": dict(local=True, genre=True, use_cos=True),
}


def _loss_inputs(rng, kw):
    """Outputs and a batch for compute_loss: local mode with padded
    windows (seq_length below the padded length, inf in some masked
    windows' outputs, window coverage below 1 for some), genre labels
    missing for some samples."""
    cfg = dict(frames=5, loc_window_size=2, **kw)
    n, t = 5, 14
    local = kw.get("local", False)
    lead = (n, t) if local else (n,)
    key_out = rng.uniform(0.01, 0.99, lead + (12,)).astype(np.float32)
    tonic_out = rng.normal(size=lead + (12,)).astype(np.float32)
    key_labels = KEY_SIGNATURE_MAP[rng.integers(0, 21, lead)].astype(
        np.float32)
    tonic_labels = np.eye(12, dtype=np.float32)[rng.integers(0, 12, lead)]
    genre = np.eye(11, dtype=np.float32)[rng.integers(0, 11, n)]
    genre[1] = 0                                      # unlabeled samples
    genre[3, :2] = 1
    batch = {"key_labels": key_labels, "tonic_labels": tonic_labels,
             "genre": genre}
    outputs = [key_out, tonic_out]
    if local:
        seq = np.array([23, 20, 17, 11, 9], np.int32)  # valid 14 11 8 2 0
        batch["seq_length"] = seq
        cov = np.ones((n, t), np.float32)
        cov[0, 3:6] = 0.4
        cov[2, 0] = 0.7
        batch["window_coverage"] = cov
        key_out[3, 5:] = np.inf                       # padded windows
        genre_out = rng.normal(size=(n, t + 4, 11)).astype(np.float32)
    else:
        genre_out = rng.normal(size=(n, 11)).astype(np.float32)
    if kw.get("genre"):
        outputs.append(genre_out)
    return cfg, outputs, batch


@pytest.mark.parametrize("weights", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_compute_loss_matches_jax(rng, case, weights):
    """Loss and every aux term against the JAX package at rtol 1e-5, with
    and without 0/1 sample weights, training and evaluation (straddle
    weighting applies to training only)."""
    cfg_kw, outputs, batch = _loss_inputs(rng, LOSS_CASES[case])
    sw = np.array([1, 1, 0, 1, 0], np.float32) if weights else None
    for train in (True, False):
        ours, aux = loss.compute_loss(
            Config(**cfg_kw), [torch.from_numpy(o) for o in outputs],
            {k: torch.from_numpy(v) for k, v in batch.items()},
            None if sw is None else torch.from_numpy(sw), train=train)
        ref, ref_aux = jax_loss.compute_loss(
            JaxConfig(**cfg_kw), [jnp.asarray(o) for o in outputs],
            {k: jnp.asarray(v) for k, v in batch.items()},
            None if sw is None else jnp.asarray(sw), train=train)
        assert np.isfinite(float(ours))
        assert sorted(aux) == sorted(ref_aux)
        for k in ref_aux:
            np.testing.assert_allclose(float(aux[k]), float(ref_aux[k]),
                                       rtol=1e-5, err_msg=k)


def test_bce_is_the_clipped_formula():
    """A saturated sigmoid gives the clipped log (-log 1e-7), not
    F.binary_cross_entropy's clamp at -100."""
    cfg = Config()
    key = torch.zeros(1, 12)
    key[0, 0] = 1.0
    labels = torch.zeros(1, 12)
    labels[0, 1] = 1.0
    tonic = torch.zeros(1, 12)
    _, aux = loss.compute_loss(cfg, (key, tonic),
                               {"key_labels": labels, "tonic_labels": tonic})
    lo, hi = np.float32(1e-7), np.float32(1) - np.float32(1e-7)
    want = -(np.log(lo) + np.log(np.float32(1) - hi)) / 12   # ~2.67, not 16.7
    np.testing.assert_allclose(float(aux["bce_loss"]), want, rtol=1e-5)


def test_loss_gradient_ignores_masked_windows(rng):
    """Padded (masked) windows with inf outputs give the loss and its
    gradient no NaN."""
    cfg_kw, outputs, batch = _loss_inputs(rng, dict(local=True))
    key = torch.from_numpy(outputs[0]).requires_grad_()
    val, _ = loss.compute_loss(Config(**cfg_kw),
                               (key, torch.from_numpy(outputs[1])),
                               {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    val.backward()
    assert torch.isfinite(val) and torch.isfinite(key.grad).all()


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_optimizer_matches_optax_over_epochs(rng):
    """make_optimizer + set_learning_rate(learning_rate(step)) against the
    JAX package's optax chain (add_decayed_weights ahead of adam, staircase
    exponential decay per epoch) in float64: 3 epochs x 3 steps, 1e-9."""
    lr, gamma, reg = 3e-4, 0.5, 1e-2
    steps_per_epoch, n_epochs = 3, 3
    shapes = [(4, 3), (7,), (2, 2, 2)]
    params0 = [rng.normal(size=s) for s in shapes]
    grads = [[rng.normal(size=s) for s in shapes]
             for _ in range(steps_per_epoch * n_epochs)]
    cfg = Config(lr=lr, gamma=gamma, reg=reg)

    tparams = [torch.tensor(p, dtype=torch.float64, requires_grad=True)
               for p in params0]
    opt = optim.make_optimizer(cfg, tparams)
    for step, g in enumerate(grads):
        for p, gi in zip(tparams, g):
            p.grad = torch.tensor(gi, dtype=torch.float64)
        optim.set_learning_rate(opt, optim.learning_rate(
            cfg, step, steps_per_epoch))
        opt.step()

    jopt = jax_optim(JaxConfig(lr=lr, gamma=gamma, reg=reg),
                     steps_per_epoch)
    jparams = [jnp.asarray(p) for p in params0]
    state = jopt.init(jparams)
    for g in grads:
        updates, state = jopt.update([jnp.asarray(x) for x in g], state,
                                     jparams)
        jparams = optax.apply_updates(jparams, updates)
    for tp, jp in zip(tparams, jparams):
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   rtol=1e-9, atol=1e-9)
    assert optim.learning_rate(cfg, 8, 3) == lr * gamma ** 2
