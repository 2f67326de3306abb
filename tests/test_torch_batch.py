"""PyTorch port: served batches larger than 16 clips, and a clip past the
largest bucket, against the JAX KeyEstimator.

`_predict_files` serves every file of one sample rate in one batch, so a
user's batch has as many rows as files. 41 distinct clips (odd, more
than 16 and no multiple of 16) go through the port's
`KeyEstimator.predict_waveforms` on the CPU and through the JAX
package's on XLA's CPU backend, with the same weights (flax init,
converted by `models.convert.state_dict_from_jax`), and are held to the
wav -> logits bars (key < 1e-3, tonic < 3e-3;
`tests/test_e2e_parity.py:65-66`). Every row must also equal that clip
served in a batch of 16 within 1e-6: a row of the batch depends on its
clip alone. A 421 s clip is padded past the (60, 180, 420) s buckets to
the next whole minute (`_bucket_len`), as the JAX estimator pads it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import traverse_util

from audio_key_estimation_tpu.config import Config as JaxConfig
from audio_key_estimation_tpu.models import PitchClassNet as JaxNet
from audio_key_estimation_tpu.predict import KeyEstimator as JaxEstimator

from audio_key_estimation_torch.config import Config
from audio_key_estimation_torch.models.convert import state_dict_from_jax
from audio_key_estimation_torch.predict import KeyEstimator

TINY = dict(octaves=4, num_layers=2, conv_layers=1, n_filters=2,
            kernel_size=3, head_layers=1, genre=True, frames=5)
SR = 8000
N_CLIPS = 41
TOL_KEY, TOL_TONIC = 1e-3, 3e-3     # wav -> logits
TOL_ROW = 1e-6                      # a row against its batch of 16


def clips(rng, n=N_CLIPS):
    """n distinct clips of 1.2-3.9 s: two partials at a per-clip pitch,
    noise, a per-clip gain, as raw int16 PCM (the serving path's input
    for PCM16 WAVs)."""
    out = []
    for i in range(n):
        t = np.arange(int(SR * rng.uniform(1.2, 3.9))) / SR
        f0 = 110.0 * 2 ** (i / 7)
        y = (0.4 * np.sin(2 * np.pi * f0 * t)
             + 0.2 * np.sin(2 * np.pi * 1.5 * f0 * t)
             + 0.05 * rng.standard_normal(t.size)) * rng.uniform(0.3, 1.0)
        out.append(np.round(np.clip(y, -1, 1) * 32767).astype(np.int16))
    return out


def jax_variables(cfg, rng):
    """flax init (jitted: the eager init takes ~20 s on this CPU) with
    the BatchNorm statistics drawn from rng, as numpy trees (the recipe
    of tests/torch_parity.jax_variables)."""
    variables = jax.jit(lambda k, x: JaxNet(cfg).init(k, x, None, False))(
        jax.random.PRNGKey(3), jnp.zeros((1, cfg.pitches, 32, 1)))
    flat = traverse_util.flatten_dict(variables["batch_stats"])
    for k in flat:
        flat[k] = (rng.normal(size=flat[k].shape) * 0.3 if k[-1] == "mean"
                   else rng.uniform(0.5, 2.0, flat[k].shape)
                   ).astype(np.float32)
    return jax.tree_util.tree_map(np.asarray, {
        "params": variables["params"],
        "batch_stats": traverse_util.unflatten_dict(flat)})


@pytest.fixture(scope="module")
def estimators():
    jcfg = JaxConfig(**TINY)
    variables = jax_variables(jcfg, np.random.default_rng(5))
    cfg = Config(**TINY)

    def pair(buckets):
        return (JaxEstimator(jcfg, variables, bucket_seconds=buckets),
                KeyEstimator(cfg, state_dict_from_jax(variables),
                             device="cpu", bucket_seconds=buckets))
    return pair


def raw(preds):
    return (np.stack([p.key_probs for p in preds]),
            np.stack([p.tonic_logits for p in preds]))


def assert_matches_jax(got, ref):
    (key, tonic), (key_ref, tonic_ref) = raw(got), raw(ref)
    assert key.shape == key_ref.shape and np.isfinite(key).all()
    assert np.abs(key - key_ref).max() < TOL_KEY
    assert np.abs(tonic - tonic_ref).max() < TOL_TONIC
    assert [p.genre for p in got] == [p.genre for p in ref]


def test_batch_of_41_matches_jax_and_its_batches_of_16(estimators):
    jax_est, est = estimators((4,))
    waves = clips(np.random.default_rng(11))
    assert len({w.size for w in waves}) == N_CLIPS
    batch, seq, _ = est.host_batch(waves, SR)
    assert batch.shape == (N_CLIPS, 4 * SR) and batch.dtype == np.int16
    got = est.predict_waveforms(waves, SR, return_raw=True)
    assert_matches_jax(got, jax_est.predict_waveforms(waves, SR,
                                                      return_raw=True))
    key, tonic = raw(got)
    # the keys answer to the audio, or equal rows would prove nothing
    assert (key.max(0) - key.min(0)).max() > 1e-2
    for lo in (0, 16, N_CLIPS - 16):
        k16, t16 = raw(est.predict_waveforms(waves[lo:lo + 16], SR,
                                             return_raw=True))
        np.testing.assert_allclose(key[lo:lo + 16], k16, rtol=0,
                                   atol=TOL_ROW)
        np.testing.assert_allclose(tonic[lo:lo + 16], t16, rtol=0,
                                   atol=TOL_ROW)


def test_clip_past_the_largest_bucket_matches_jax(estimators):
    jax_est, est = estimators((60, 180, 420))
    rng = np.random.default_rng(12)
    waves = clips(rng, 1)
    t = np.arange(421 * SR) / SR
    waves.append(np.round(0.4 * 32767 * np.sin(2 * np.pi * 196.0 * t)
                          ).astype(np.int16))
    assert est._bucket_len(421.0) == jax_est._bucket_len(421.0) == 480
    batch, seq, hop = est.host_batch(waves, SR)
    assert batch.shape == (2, 480 * SR)
    assert seq[-1] == 1 + 421 * SR // hop
    assert_matches_jax(est.predict_waveforms(waves, SR, return_raw=True),
                       jax_est.predict_waveforms(waves, SR,
                                                 return_raw=True))
