"""PyTorch port: sharded serving, KeyEstimator(mesh=...), against the JAX
KeyEstimator over its 8-device CPU mesh.

Three PCM16 clips (5.0, 3.0 and 4.2 s at 8 kHz) on a mesh of k = 3 and
k = 8 CPU devices (the batch padded by zero rows of seq_length 1 to a
multiple of k, as the JAX estimator's _mesh_pad does, 5 pad rows at
k = 8), for the global model (genre on), local mode and the averaging
multi-scale ensemble, against the JAX KeyEstimator(mesh=make_mesh((8,)))
on the same weights and against the port unsharded: keys, tonics (and
genres, windows) equal, key probabilities within rtol 2e-4 / atol 2e-5
(tests/test_predict.py:144-170). The weights are the port's seeded
initialization with measured-looking BatchNorm statistics (drawn at
random, so eval-mode normalization is not the identity), carried into
the JAX variables by its torch_port.state_dict_to_variables.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_key_estimation_tpu.config import Config as JaxConfig
from audio_key_estimation_tpu.models import PitchClassNet as JaxNet
from audio_key_estimation_tpu.models.multi_scale import \
    PitchClassNetMulti as JaxMulti
from audio_key_estimation_tpu.models.torch_port import state_dict_to_variables
from audio_key_estimation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from audio_key_estimation_tpu.predict import KeyEstimator as JaxEstimator

from audio_key_estimation_torch.config import Config
from audio_key_estimation_torch.data import audio_io
from audio_key_estimation_torch.models import build_model
from audio_key_estimation_torch.parallel.mesh import make_mesh
from audio_key_estimation_torch.predict import KeyEstimator

SMALL = dict(octaves=4, num_layers=2, conv_layers=1, n_filters=2,
             kernel_size=3, head_layers=1, frames=5, loc_window_size=2,
             cqt_conv_dtype="float32")
MODELS = {"global": dict(genre=True), "multi_scale": dict(multi_scale=True)}
SR = 8000
SECONDS = (5.0, 3.0, 4.2)
BUCKET = (6,)


def _wavs(tmp_path):
    paths = []
    for i, (f, s) in enumerate(zip((261.6, 440.0, 330.0), SECONDS)):
        t = np.arange(int(SR * s)) / SR
        y = 0.4 * np.sin(2 * np.pi * f * t) + 0.2 * np.sin(3 * np.pi * f * t)
        paths.append(str(tmp_path / f"s{i}.wav"))
        audio_io.write_wav(paths[-1], y, SR)
    return paths


@functools.lru_cache(maxsize=None)
def weights(name: str):
    """(cfg, port state_dict, JAX variables) for one model."""
    cfg = Config(**SMALL, **MODELS[name])
    net = build_model(cfg)
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for k, b in net.named_buffers():
            b.copy_(torch.from_numpy(
                (rng.normal(size=b.shape) * 0.3 if k.endswith("mean")
                 else rng.uniform(0.5, 2.0, b.shape)).astype(np.float32)))
    sd = {k: v.numpy().copy() for k, v in net.state_dict().items()}
    cfg_j = JaxConfig(**SMALL, **MODELS[name])
    if cfg.multi_scale:
        model = JaxMulti(cfg_j)
        args = (jnp.zeros((1, cfg.pitches, 64, 1)),
                jnp.zeros((1, cfg.octaves * 12, 64, 1)))
    else:
        model = JaxNet(cfg_j)
        args = (jnp.zeros((1, cfg.pitches, 64, 1)),)
    template = jax.eval_shape(lambda k: model.init(k, *args, None, False),
                              jax.random.PRNGKey(0))
    return cfg, sd, state_dict_to_variables(sd, template)


def _predict(est, paths, local):
    fn = est.predict_files_local if local else est.predict_files
    return fn(paths, return_raw=True)


@functools.lru_cache(maxsize=None)
def jax_reference(name: str, local: bool, paths: tuple):
    cfg, _, variables = weights(name)
    est = JaxEstimator(JaxConfig(**SMALL, **MODELS[name]), variables,
                       bucket_seconds=BUCKET, mesh=jax_make_mesh((8,)))
    return _predict(est, list(paths), local)


def _assert_same(got, ref, local):
    assert len(got) == len(ref) == len(SECONDS)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.key_probs, r.key_probs, rtol=2e-4,
                                   atol=2e-5)
        if local:
            assert len(g.windows) == len(r.windows) > 0
            for gw, rw in zip(g.windows, r.windows):
                assert (gw.start, gw.end, gw.key, gw.tonic, gw.genre) == \
                    (rw.start, rw.end, rw.key, rw.tonic, rw.genre)
        else:
            assert (g.key, g.tonic, g.genre) == (r.key, r.tonic, r.genre)


@pytest.mark.parametrize("k", [3, 8])
@pytest.mark.parametrize("local", [False, True], ids=["global", "local"])
@pytest.mark.parametrize("name", list(MODELS))
def test_sharded_serving_matches_jax_mesh(tmp_path_factory, name, local, k):
    paths = tuple(_wavs(tmp_path_factory.mktemp("wav")))
    cfg, sd, _ = weights(name)
    est = KeyEstimator(cfg, sd, bucket_seconds=BUCKET,
                       mesh=make_mesh(devices=[torch.device("cpu")] * k))
    assert len(est.replicas) == len(est.local_replicas) == k
    got = _predict(est, list(paths), local)
    _assert_same(got, jax_reference(name, local, paths), local)
    plain = KeyEstimator(cfg, sd, device="cpu", bucket_seconds=BUCKET)
    _assert_same(got, _predict(plain, list(paths), local), local)


def test_sharded_batch_is_padded_with_silent_rows():
    """Three clips on five devices: two zero rows of seq_length 1 pad the
    host batch, every shard gets one row, and the outputs keep three."""
    cfg, sd, _ = weights("global")
    est = KeyEstimator(cfg, sd, bucket_seconds=BUCKET,
                       mesh=make_mesh(devices=[torch.device("cpu")] * 5))
    waves = [np.full(int(SR * s), 1000, np.int16) for s in SECONDS]
    batch, seq, hop = est.host_batch(waves, SR)
    assert batch.shape == (5, SR * BUCKET[0]) and batch.dtype == np.int16
    assert not batch[3:].any() and list(seq[3:]) == [1, 1]
    out, seq_out = est.outputs(waves, SR)
    assert [o.shape[0] for o in out] == [3, 3, 3]
    assert list(seq_out) == list(seq[:3])
