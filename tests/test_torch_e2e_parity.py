"""PyTorch port: wav -> final logits against the JAX package and against
the reference-shaped pipeline, on the CPU.

The counterpart of tests/test_e2e_parity.py at its geometry (4 synthetic
triad WAVs of 6 s, octaves 4, hop 4416 — librosa's hop % 2**(octaves-1)
rule — T = 30, its CFG, flax init with randomized BatchNorm statistics,
weights carried into the port by models/convert.state_dict_from_jax).
Three pipelines on the same files:

  port:       the port's decode (raw int16) -> plain CQT (float32
              streams; kernels A and B take this path for CPU tensors)
              -> the port's PitchClassNet
  jax:        the JAX package's decode -> XLA CQT -> flax forward
  reference:  PCM/32768 -> the port's librosa-0.9.2-algorithm oracle
              (ops/librosa_ref.py, float64) -> log1p
              -> tests/torch_funcref.torch_forward (float64)

Bars: port against jax at tests/test_e2e_parity.py's TOL_PALLAS (1e-4 on
the final logits); port against the reference at its TOL_KEY / TOL_TONIC
(key sigmoid 1e-3, tonic logit 3e-3); key, signature row, tonic and MIREX
calls identical on every clip. The JAX side runs its XLA front-end, not
Pallas interpret mode, and its init and forward are jitted once.
Measured on the CPU: port against jax 6.0e-8 (key) / 5.2e-8 (tonic),
features 2.2e-6; port against the reference 4.3e-5 / 2.4e-4 (the JAX
test measured 9.5e-5 / 2.8e-4 for its own pipeline).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from audio_key_estimation_tpu.config import Config as JaxConfig
from audio_key_estimation_tpu.data import audio_io as jax_audio_io
from audio_key_estimation_tpu.models import PitchClassNet as JaxNet
from audio_key_estimation_tpu.ops.cqt import CQTParams as JaxCQTParams
from audio_key_estimation_tpu.ops.frontend import \
    compute_cqt as jax_compute_cqt

from audio_key_estimation_torch.config import Config
from audio_key_estimation_torch.data import audio_io
from audio_key_estimation_torch.models import PitchClassNet
from audio_key_estimation_torch.models.convert import (load_state_dict,
                                                       state_dict_from_jax)
from audio_key_estimation_torch.ops.cqt import CQTParams
from audio_key_estimation_torch.ops.frontend import compute_cqt
from audio_key_estimation_torch.ops.librosa_ref import librosa_cqt
from audio_key_estimation_torch.predict import key_name
from audio_key_estimation_torch.train.metrics import mirex_categories
from audio_key_estimation_torch.utils.key_signatures import KEY_SIGNATURE_MAP

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_funcref import torch_forward  # noqa: E402

SR, HOP, SECONDS, N = 22050, 4416, 6.0, 4  # hop % 2**(octaves-1) == 0
CFG_KW = dict(octaves=4, num_layers=2, conv_layers=1, n_filters=2,
              kernel_size=3, head_layers=1, genre=False, frames=5)

TOL_KEY = 1e-3     # tests/test_e2e_parity.py:65
TOL_TONIC = 3e-3   # :66
TOL_PALLAS = 1e-4  # :67, the port's front-end and model against the JAX


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The oracles run thousands of small tensor ops. Beside the suite's
    other workers, torch's intra-op threads contend for the cores and
    each op waits for all of them (20-50x slower, measured), so this
    module runs on one thread and gives the worker's count back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _write_triads(root) -> list:
    """tests/test_e2e_parity.py's four triad WAVs (same seed, same
    samples), written with the port's writer."""
    rng = np.random.default_rng(7)
    L = int(SR * SECONDS)
    t = np.arange(L) / SR
    paths = []
    for i in range(N):
        f0 = 110.0 * 2 ** (((i * 5) % 12) / 12)
        y = np.zeros(L)
        for mult, amp in ((1, .35), (2 ** (4 / 12), .25),
                          (2 ** (7 / 12), .25), (2, .15)):
            y += amp * np.sin(2 * np.pi * f0 * mult * t + rng.uniform(0, 6))
        y += 0.01 * rng.standard_normal(L)
        paths.append(str(root / f"w{i}.wav"))
        audio_io.write_wav(paths[-1], (y * 0.5).astype(np.float32), SR)
    return paths


def _jax_weights(T: int):
    """(flax model, variables with non-trivial eval-mode BatchNorm
    statistics), as tests/test_e2e_parity.py draws them."""
    model = JaxNet(JaxConfig(**CFG_KW))
    init = jax.jit(model.init, static_argnums=3)
    variables = init(jax.random.PRNGKey(3),
                     jnp.zeros((1, 4 * 36, T, 1), jnp.float32),
                     jnp.full((1,), T, jnp.int32), False)
    flat = traverse_util.flatten_dict(variables["batch_stats"])
    r2 = np.random.default_rng(11)
    for k in flat:
        flat[k] = (jnp.asarray(r2.normal(size=flat[k].shape) * 0.3,
                               jnp.float32) if k[-1] == "mean"
                   else jnp.asarray(r2.uniform(0.5, 2.0, flat[k].shape),
                                    jnp.float32))
    variables = {"params": variables["params"],
                 "batch_stats": traverse_util.unflatten_dict(flat)}
    return model, jax.tree_util.tree_map(np.asarray, variables)


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    """Run the three pipelines once; the tests assert on the result."""
    paths = _write_triads(tmp_path_factory.mktemp("e2e"))

    # ---- the port: decode -> plain CQT -> PitchClassNet
    batch = np.stack([w for w, _ in audio_io.decode_many(paths, raw=True)])
    assert batch.dtype == np.int16
    p = CQTParams(sr=SR, hop=HOP, bins_per_octave=36, octaves=4)
    mel = compute_cqt(torch.from_numpy(batch), p, use_kernels=False,
                      conv_dtype="float32")

    # ---- the JAX package: decode -> XLA CQT -> flax
    jbatch = np.stack([w for w, _ in jax_audio_io.decode_many(paths,
                                                              raw=True)])
    np.testing.assert_array_equal(jbatch, batch)
    jp = JaxCQTParams(sr=SR, hop=HOP, bins_per_octave=36, octaves=4)
    mel_j = np.asarray(jax.jit(lambda y: jax_compute_cqt(
        y, jp, use_pallas=False, conv_dtype="float32"))(jnp.asarray(jbatch)))

    # ---- the reference: librosa-0.9.2 algorithm in float64, batched
    mel_r = torch.log1p(librosa_cqt(batch.astype(np.float64) / 32768.0, SR,
                                    HOP, 36 * 4, 36).abs())
    T = min(mel.shape[2], mel_r.shape[2])
    mel, mel_j, mel_r = mel[:, :, :T], mel_j[:, :, :T], mel_r[:, :, :T]
    seq = np.full((N,), T, np.int32)

    model, variables = _jax_weights(T)
    sd = state_dict_from_jax(variables)
    net = PitchClassNet(Config(**CFG_KW))
    load_state_dict(net, sd)
    with torch.no_grad():
        out = net.eval()(mel[..., None], torch.from_numpy(seq))
    apply = jax.jit(model.apply, static_argnums=3)
    out_j = apply(variables, jnp.asarray(mel_j[..., None]), jnp.asarray(seq),
                  False)
    out_r = torch_forward(sd, Config(**CFG_KW), mel_r[:, None], seq)
    return {"port": [o.numpy() for o in out],
            "jax": [np.asarray(o) for o in out_j],
            "ref": [o.numpy() for o in out_r],
            "mel": (mel.numpy(), mel_j, mel_r.numpy())}


def test_front_end_matches_jax(pipelines):
    """The port's plain CQT of the decoded PCM16 equals the JAX XLA
    front-end's (tests/test_cqt_pallas.py:47's f32 bar)."""
    mel, mel_j, _ = pipelines["mel"]
    np.testing.assert_allclose(mel, mel_j, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("head,i", [("key", 0), ("tonic", 1)])
def test_final_logits_match_jax_pipeline(pipelines, head, i):
    d = np.abs(pipelines["port"][i] - pipelines["jax"][i]).max()
    assert d < TOL_PALLAS, (head, d)


@pytest.mark.parametrize("head,i,tol", [("key", 0, TOL_KEY),
                                        ("tonic", 1, TOL_TONIC)])
def test_final_logits_match_reference_pipeline(pipelines, head, i, tol):
    d = np.abs(pipelines["port"][i] - pipelines["ref"][i]).max()
    assert d < tol, (head, d)


def test_key_calls_identical(pipelines):
    """The serving-level reading agrees clip by clip."""
    for i in range(N):
        calls = [key_name(pipelines[k][0][i], pipelines[k][1][i])
                 for k in ("port", "jax", "ref")]
        for field in ("signature_row", "tonic", "key"):
            assert len({c[field] for c in calls}) == 1, (i, calls)


def test_mirex_categories_identical(pipelines):
    """Every pipeline lands in the same MIREX category for any truth."""
    rows = np.arange(N) % 15
    key_labels = torch.as_tensor(KEY_SIGNATURE_MAP[rows])
    tonic_labels = torch.as_tensor(np.eye(12, dtype=np.float32)[
        [(11 + 7 * r) % 12 for r in rows]])
    sig_id = torch.as_tensor(np.eye(21, dtype=np.float32)[rows])
    cats = {k: mirex_categories(key_labels, torch.tensor(v[0]).float(),
                                tonic_labels, torch.tensor(v[1]).float(),
                                sig_id)
            for k, v in pipelines.items() if k != "mel"}
    for name in cats["port"]:
        for k in ("jax", "ref"):
            np.testing.assert_array_equal(cats["port"][name].numpy(),
                                          cats[k][name].numpy(),
                                          err_msg=f"{name} {k}")
