"""PyTorch port: the multi-scale ensemble (PitchClassNetMulti) against the
JAX package on the CPU.

At a small geometry (octaves=4, num_layers=2, conv_layers=1, n_filters=2,
kernel_size=3, head_layers=1), with the JAX ensemble's weights carried
across by `state_dict_from_jax` (BatchNorm statistics randomized, so
eval-mode normalization is not the identity):
 * the model, averaging, `linear_reg_multi` and `linear_reg_multi` with
   genre, global (with and without sequence lengths) and local, against
   flax's PitchClassNetMulti.apply: key rtol 1e-4 / atol 1e-5, tonic and
   genre rtol/atol 1e-4 (tests/test_torch_port.py:171-176);
 * the conversion: state_dict_from_jax gives the JAX package's own export
   (`model1.`, `model2.`, `wk`...`bg`) and loads strictly;
 * serving: `KeyEstimator.predict_files` and `predict_files_local` on
   WAVs against the JAX KeyEstimator (tests/test_torch_predict.py's and
   tests/test_torch_local.py's bars), and the config/weights mismatch
   refused both ways;
 * training: one train step's loss and gradients and three steps from a
   carried-over optax state (Adam moments through adam_state_from_jax)
   against the JAX trainer, computing in float64, on `mel2` batches from
   KeyDataset (tests/test_torch_train.py's bars);
 * the CLIs: train --multi_scale, eval, predict --torch_ckpt
   [--local_windows];
 * chip_smoke.expected_launches at the default widths: A 14, B 2, C 6.
Each JAX ensemble is built once per process (jitted init; flax's eager
init is slow on the CPU).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from audio_key_estimation_tpu.config import Config as JaxConfig
from audio_key_estimation_tpu.models.multi_scale import \
    PitchClassNetMulti as JaxMulti
from audio_key_estimation_tpu.models.torch_port import variables_to_state_dict
from audio_key_estimation_tpu.predict import KeyEstimator as JaxEstimator
from audio_key_estimation_tpu.train import trainer as jax_trainer
from audio_key_estimation_tpu.train.loss import compute_loss as jax_loss
from audio_key_estimation_tpu.train.optim import make_optimizer as jax_optim

from audio_key_estimation_torch.cli import eval as eval_cli
from audio_key_estimation_torch.cli import predict as predict_cli
from audio_key_estimation_torch.cli import train as train_cli
from audio_key_estimation_torch.config import Config
from audio_key_estimation_torch.data import audio_io, loaders, synthetic
from audio_key_estimation_torch.data.dataset import KeyDataset
from audio_key_estimation_torch.models import (PitchClassNet,
                                               PitchClassNetMulti,
                                               build_model)
from audio_key_estimation_torch.models.convert import (
    adam_state_from_jax, load_adam_state, load_state_dict, match_names,
    state_dict_from_jax)
from audio_key_estimation_torch.predict import KeyEstimator
from audio_key_estimation_torch.train import trainer
from test_torch_cli_train import ARCH, _mtg_corpus
from test_torch_train import (_by_port_name, _np, _rounding_floor,
                              assert_close_to_scale)

SMALL = dict(octaves=4, num_layers=2, conv_layers=1, n_filters=2,
             kernel_size=3, head_layers=1, frames=5, loc_window_size=2,
             cqt_conv_dtype="float32", multi_scale=True)
KINDS = {"average": dict(genre=True),
         "linear_reg": dict(linear_reg_multi=True),
         "linear_reg_genre": dict(linear_reg_multi=True, genre=True)}
SR = 8000


def _zeros(cfg, t=32):
    return (jnp.zeros((1, cfg.octaves * 36, t, 1), jnp.float32),
            jnp.zeros((1, cfg.octaves * 12, t, 1), jnp.float32))


@functools.lru_cache(maxsize=None)
def ensemble(kind: str):
    """(cfg, flax PitchClassNetMulti, numpy variables with randomized
    BatchNorm statistics) for one merge kind."""
    cfg = JaxConfig(**SMALL, **KINDS[kind])
    model = JaxMulti(cfg)
    variables = jax.jit(lambda k: model.init(k, *_zeros(cfg), None, False))(
        jax.random.PRNGKey(5))
    rng = np.random.default_rng(11)
    flat = traverse_util.flatten_dict(variables["batch_stats"])
    for k in flat:
        flat[k] = (rng.normal(size=flat[k].shape) * 0.3 if k[-1] == "mean"
                   else rng.uniform(0.5, 2.0, flat[k].shape)
                   ).astype(np.float32)
    variables = {"params": variables["params"],
                 "batch_stats": traverse_util.unflatten_dict(flat)}
    return cfg, model, jax.tree_util.tree_map(np.asarray, variables)


def _port(cfg, variables):
    net = build_model(cfg)
    load_state_dict(net, state_dict_from_jax(variables))
    return net.eval()


# ---------------------------------------------------------------------------
# the model and its weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["global", "lengths", "local"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_forward_matches_flax(kind, mode):
    """The port's ensemble on the JAX ensemble's weights, one seeded
    (2, rows, 40, 1) input pair: global mode without and with sequence
    lengths (masked temporal mean), or local mode (time-major outputs,
    T' = 40 - frames * loc_window_size + 1, the genre head
    40 - head_layers (k - 1)).
    Key rtol 1e-4 / atol 1e-5, tonic and genre rtol/atol 1e-4."""
    cfg, model, variables = ensemble(kind)
    if mode == "local":
        cfg = cfg.replace(local=True)
        model = JaxMulti(cfg)
    g = np.random.default_rng(2)
    mel1 = g.normal(size=(2, cfg.octaves * 36, 40, 1)).astype(np.float32)
    mel2 = g.normal(size=(2, cfg.octaves * 12, 40, 1)).astype(np.float32)
    seq = np.array([40, 27], np.int32) if mode == "lengths" else None
    out_j = model.apply(variables, jnp.asarray(mel1), jnp.asarray(mel2),
                        None if seq is None else jnp.asarray(seq), False)
    net = _port(cfg, variables)
    assert isinstance(net, PitchClassNetMulti)
    with torch.no_grad():
        out_t = net(torch.from_numpy(mel1), torch.from_numpy(mel2),
                    None if seq is None else torch.from_numpy(seq))
    assert len(out_t) == len(out_j) == (3 if cfg.genre else 2)
    if mode == "local":
        assert tuple(out_t[0].shape) == (2, 31, 12)
        if cfg.genre:
            assert tuple(out_t[2].shape) == (2, 38, 11)
    for i, (j, t) in enumerate(zip(out_j, out_t)):
        assert tuple(t.shape) == tuple(j.shape)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-5 if i == 0 else 1e-4)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_state_dict_from_jax_loads_strictly(kind):
    """state_dict_from_jax equals the JAX package's variables_to_state_dict
    key for key and array for array: both towers under `model1.` and
    `model2.`, the regression weights at the top level; every key of the
    port's ensemble is filled from it and none is left over (the export
    names an equivariant conv `X.weight`, the port `X.conv2d.weight`), and
    the ensemble's own state_dict loads into a plain torch
    load_state_dict."""
    cfg, _, variables = ensemble(kind)
    got = state_dict_from_jax(variables)
    ref = variables_to_state_dict(variables)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    tops = {k for k in got if "." not in k}
    want = set()
    if cfg.linear_reg_multi:
        want = {"wk", "bk", "wt", "bt"} | ({"wg", "bg"} if cfg.genre
                                          else set())
    assert tops == want
    assert {k.split(".")[0] for k in got} == {"model1", "model2"} | want
    net = _port(cfg, variables)
    names = match_names(net.state_dict(), got)     # raises on a leftover
    for k, v in net.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), got[names[k]], err_msg=k)
    other = PitchClassNetMulti(cfg, torch.Generator().manual_seed(1))
    other.load_state_dict(net.state_dict(), strict=True)


def test_pitchclassnet_refuses_multi_scale():
    """PitchClassNet does not build one tower of a multi-scale Config;
    build_model picks the class; the ensemble's regression weights are
    drawn from the generator, N(0, 1), in the model's dtype."""
    cfg = Config(**SMALL, linear_reg_multi=True)
    with pytest.raises(ValueError, match="PitchClassNetMulti"):
        PitchClassNet(cfg)
    a = build_model(cfg, torch.Generator().manual_seed(0))
    b = build_model(cfg, torch.Generator().manual_seed(0))
    assert isinstance(a, PitchClassNetMulti)
    assert isinstance(build_model(cfg.replace(multi_scale=False)),
                      PitchClassNet)
    assert a.model2.cfg.only_semitones and not a.model1.cfg.only_semitones
    assert a.wk.shape == (2, 12) and a.bt.shape == (12,)
    assert not hasattr(a, "wg")
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    assert a.wk.std() > 0.3
    half = build_model(cfg.replace(dtype="bfloat16", genre=True))
    assert half.wg.shape == (2, 11) and half.wg.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _wavs(tmp_path, seconds=(5.0, 3.3)):
    paths = []
    for i, (f, s) in enumerate(zip((330.0, 440.0), seconds)):
        t = np.arange(int(SR * s)) / SR
        y = 0.4 * np.sin(2 * np.pi * f * t) + 0.2 * np.sin(3 * np.pi * f * t)
        paths.append(str(tmp_path / f"s{i}.wav"))
        audio_io.write_wav(paths[-1], y, SR)
    return paths


@pytest.mark.parametrize("kind", ["average", "linear_reg_genre"])
def test_predict_files_matches_jax(tmp_path, kind):
    """predict_files through the ensemble (two CQTs: 36 and 12
    bins/octave) against the JAX KeyEstimator on the same WAVs and
    weights: key probabilities and tonic logits rtol/atol 1e-4, names and
    genre equal, confidence within 1e-4."""
    cfg, _, variables = ensemble(kind)
    paths = _wavs(tmp_path)
    ref = JaxEstimator(cfg, variables, bucket_seconds=(6,)).predict_files(
        paths, return_raw=True)
    est = KeyEstimator(cfg, state_dict_from_jax(variables), device="cpu",
                       bucket_seconds=(6,))
    assert isinstance(est.model, PitchClassNetMulti)
    batch, _, hop = est.make_batch([audio_io.decode_audio(p, raw=True)[0]
                                    for p in paths], SR)
    mels = est.features(batch, SR, hop)
    assert [m.shape[1] for m in mels] == [cfg.octaves * 36, cfg.octaves * 12]
    got = est.predict_files(paths, return_raw=True)
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.key_probs, r.key_probs, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(g.tonic_logits, r.tonic_logits,
                                   rtol=1e-4, atol=1e-4)
        assert (g.key, g.tonic, g.genre) == (r.key, r.tonic, r.genre)
        assert abs(g.confidence - r.confidence) < 1e-4


def test_predict_files_local_matches_jax(tmp_path):
    """predict_files_local through the averaging ensemble against the
    JAX one: 17 and 8 windows, spans, names and genres equal, key
    probabilities and tonic logits rtol/atol 1e-4."""
    cfg, _, variables = ensemble("average")
    paths = _wavs(tmp_path)
    ref = JaxEstimator(cfg, variables, bucket_seconds=(6,)) \
        .predict_files_local(paths, return_raw=True)
    est = KeyEstimator(cfg, state_dict_from_jax(variables), device="cpu",
                       bucket_seconds=(6,))
    assert isinstance(est.local_model, PitchClassNetMulti)
    got = est.predict_files_local(paths, return_raw=True)
    assert [len(g.windows) for g in got] == [len(r.windows) for r in ref] \
        == [17, 8]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.key_probs, r.key_probs, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(g.tonic_logits, r.tonic_logits,
                                   rtol=1e-4, atol=1e-4)
        for gw, rw in zip(g.windows, r.windows):
            assert (gw.start, gw.end, gw.key, gw.tonic, gw.genre) == \
                (rw.start, rw.end, rw.key, rw.tonic, rw.genre)


def test_weights_config_mismatch_raises():
    """Ensemble weights under a single-scale Config, and single-scale
    weights under a multi-scale one, are refused (as the JAX
    KeyEstimator refuses them), naming multi_scale."""
    cfg = Config(**SMALL)
    multi = build_model(cfg).state_dict()
    single = build_model(cfg.replace(multi_scale=False)).state_dict()
    with pytest.raises(ValueError, match="multi_scale"):
        KeyEstimator(cfg.replace(multi_scale=False), multi, device="cpu")
    with pytest.raises(ValueError, match="multi_scale"):
        KeyEstimator(cfg, single, device="cpu")
    assert isinstance(KeyEstimator(cfg, multi, device="cpu").model,
                      PitchClassNetMulti)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

TRAIN = dict(octaves=4, num_layers=2, conv_layers=1, n_filters=2,
             kernel_size=3, head_layers=1, bucket_sizes=(32,), batch_size=4,
             acc_grad=2, frames=5, multi_scale=True,
             cqt_conv_dtype="float32")
STEPS_PER_EPOCH = 2
# The JAX side of the training tests computes in float64 (conftest enables
# x64): on these CQT features (log1p values up to ~3, zero-padded tails)
# the JAX ensemble's own float32 gradients after two steps lie up to 2.6%
# of a tensor's largest off its float64 gradients (model1's layer-0
# convs), where the port's float32 ones lie within 2.6e-7. Against the
# float64 reference the port is held to tests/test_torch_train.py's bars.
F64 = jnp.float64


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64)
        if np.asarray(a).dtype == np.float32 else np.asarray(a), tree)


@functools.lru_cache(maxsize=None)
def jax_train_side():
    """(cfg, initial TrainState as float64 numpy, the jitted train_step,
    the jitted per-micro-batch value_and_grad) of the JAX ensemble
    computing in float64, from PRNGKey(0)'s float32 weights."""
    cfg = JaxConfig(**TRAIN)
    model = JaxMulti(cfg)
    variables = _f64(jax.jit(lambda k: model.init(
        k, *_zeros(cfg, 64), None, False))(jax.random.PRNGKey(0)))
    model = JaxMulti(cfg, dtype=F64)
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
    return cfg, _np(state), step, grad_fn


@functools.lru_cache(maxsize=None)
def train_songs(root: str) -> KeyDataset:
    """Eight scale-walk songs of 5.0 and 3.6 s (T = 26 and 19 frames)
    imported by the port's KeyDataset on the CPU with mel2."""
    keys = ["C major", "A minor", "G major", "E minor"]
    for seconds, part in ((5.0, "a"), (3.6, "b")):
        synthetic.make_giantsteps_corpus(
            root, [(f"{part}{i}", 0.0, keys[i % 4], "techno")
                   for i in range(4)], seconds=seconds, scale_audio=True,
            seed_offset=ord(part))
    ds = KeyDataset(False, Config(**TRAIN), blacklist_path="",
                    use_cache=False, device="cpu")
    ds.import_data(loaders.GiantStepsKeyLoader(root), progress=False)
    return ds


def _batches(ds, n):
    """n stacked (acc_grad, batch_size, ...) batches of all eight songs,
    shuffled by seeds 0..n-1."""
    cfg = Config(**TRAIN)
    out = []
    for seed in range(n):
        b = next(ds.batches(8, shuffle=True, seed=seed, drop_last=True))
        b.pop("valid")
        out.append({k: np.reshape(v, (cfg.acc_grad, cfg.batch_size)
                                  + v.shape[1:]) for k, v in b.items()})
    return out


def _grads_jax(s0, batch):
    grad_fn = jax_train_side()[3]
    bs, losses, total = s0.batch_stats, [], None
    for i in range(batch["mel"].shape[0]):
        micro = _f64({k: v[i] for k, v in batch.items()})
        (loss, bs), g = grad_fn(s0.params, bs, micro)
        losses.append(float(loss))
        total = g if total is None else jax.tree_util.tree_map(jnp.add,
                                                               total, g)
    return (float(np.mean(losses)),
            jax.tree_util.tree_map(lambda g: np.asarray(g) / len(losses),
                                   total), _np(bs))


def _port_state(jstate, adam=False):
    state = trainer.create_train_state(Config(**TRAIN), 0, "cpu")
    assert isinstance(state.model, PitchClassNetMulti)
    load_state_dict(state.model, state_dict_from_jax(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    if adam:
        load_adam_state(state.optimizer, state.model,
                        adam_state_from_jax(jstate.opt_state))
        state.step = int(jstate.step)
    return state


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_train_step_matches_jax(tmp_path):
    """One train_step of the ensemble at acc_grad=2 on KeyDataset batches
    carrying mel2 (both towers' statistics carried from one micro-batch
    to the next), against the JAX ensemble's float64 step: loss rtol
    1e-5; each gradient within 1e-4 of its tensor's largest magnitude
    plus 1e-5 of the model's largest; both towers' running statistics
    rtol 1e-5 (tests/test_torch_train.py's bars)."""
    ds = train_songs(str(tmp_path / "gs"))
    batch = _batches(ds, 1)[0]
    assert batch["mel2"].shape == (2, 4, 48, 32, 1)
    assert batch["mel"].shape == (2, 4, 144, 32, 1)
    _, s0, _, _ = jax_train_side()
    loss_j, grads_j, bs_j = _grads_jax(s0, batch)
    state = _port_state(s0)
    step = trainer.make_train_step(Config(**TRAIN), STEPS_PER_EPOCH, seed=0)
    loss_t = float(step(state, _tensors(batch))["loss"])
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    params = dict(state.model.named_parameters())
    want = _by_port_name(params.items(), state_dict_from_jax(
        {"params": grads_j}))
    assert want.keys() == params.keys()
    assert {k.split(".")[0] for k in params} == {"model1", "model2"}
    assert_close_to_scale({k: p.grad.numpy() for k, p in params.items()},
                          want, 1e-4, 1e-5)
    buffers = dict(state.model.named_buffers())
    stats = _by_port_name(buffers.items(), state_dict_from_jax(
        {"batch_stats": bs_j}))
    for k, v in stats.items():
        np.testing.assert_allclose(buffers[k].numpy(), v, rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_three_steps_from_a_jax_state_match(tmp_path):
    """Two JAX steps (float64) give a mid-run ensemble state; the port
    takes it over (state_dict_from_jax, adam_state_from_jax) and both take
    three more steps on the same batches. Bars as tests/test_torch_train.py's
    test_three_steps_from_a_jax_state_match: losses rtol 1e-5; parameters
    1e-3 * lr, or 2 * lr a step for those whose gradient sits at the
    rounding floor (largest JAX gradient below 1e-5 of the model's);
    batch_stats rtol 1e-5 (means also within the floor parameters' bar);
    Adam's moments within 1e-4 of their tensor's largest magnitude plus
    1e-5 of the model's largest; Adam's count 5."""
    ds = train_songs(str(tmp_path / "gs"))
    batches = _batches(ds, 5)
    cfg_j, s0, step_j, _ = jax_train_side()
    s = jax.tree_util.tree_map(jnp.asarray, s0)
    for b in batches[:2]:
        s, _ = step_j(s, _f64(b))
    mid = _np(s)
    state = _port_state(mid, adam=True)
    assert state.step == 2
    model = state.model
    floor = _rounding_floor(model, _grads_jax(mid, batches[2])[1])
    step_t = trainer.make_train_step(Config(**TRAIN), STEPS_PER_EPOCH,
                                     seed=0)
    for b in batches[2:]:
        s, m_j = step_j(s, _f64(b))
        m_t = step_t(state, _tensors(b))
        np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                                   rtol=1e-5)
    end = _np(s)
    assert state.step == int(end.step) == 5
    lr = cfg_j.lr
    params = dict(model.named_parameters())
    want = _by_port_name(params.items(),
                         state_dict_from_jax({"params": end.params}))
    for k, v in want.items():
        d = np.abs(params[k].detach().numpy() - v).max()
        assert d <= (2 * lr * 3 if k in floor else 1e-3 * lr), (k, d)
    buffers = dict(model.named_buffers())
    stats = _by_port_name(buffers.items(), state_dict_from_jax(
        {"batch_stats": end.batch_stats}))
    for k, v in stats.items():
        # a floor bias shifts the batch means its BatchNorm averages in
        np.testing.assert_allclose(
            buffers[k].numpy(), v, rtol=1e-5,
            atol=2 * lr * 3 if k.endswith("mean") else 1e-6, err_msg=k)
    moments = _by_port_name(params.items(), adam_state_from_jax(end.opt_state))
    assert moments.keys() == params.keys()
    for name in ("exp_avg", "exp_avg_sq"):
        assert_close_to_scale(
            {k: state.optimizer.state[params[k]][name].numpy()
             for k in moments}, {k: st[name] for k, st in moments.items()},
            1e-4, 1e-5)
    for k, st in moments.items():
        assert float(state.optimizer.state[params[k]]["step"]) \
            == float(st["step"]) == 5


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def test_train_eval_predict_cli_round_trip(tmp_path, monkeypatch):
    """train --multi_scale --linear_reg_multi (--debug, 2 epochs) writes
    an ensemble run; the eval CLI reproduces its final validation metrics
    exactly from config.json; predict serves the run (--version) and its
    best_model.pt (--torch_ckpt with the architecture flags), globally and
    with --local_windows, the same keys either way."""
    root = _mtg_corpus(tmp_path)
    monkeypatch.chdir(tmp_path)
    logs = tmp_path / "Model_logs"
    flags = [*ARCH, "--multi_scale", "--linear_reg_multi"]
    args = ["--debug", "--epochs", "2", "--data_root", str(tmp_path),
            "--log_dir", str(logs), *flags, "--bucket_sizes", "32",
            "--no_test", "--device", "cpu"]
    val = train_cli.main(args)
    assert val["num_samples"] == 4 and np.isfinite(val["loss"])
    run = logs / "lightning_logs" / "version_0"
    sd = torch.load(run / "best_model.pt", weights_only=True)
    assert {"wk", "bk", "wt", "bt"} <= set(sd)
    assert any(k.startswith("model2.") for k in sd)

    seen = []
    real = eval_cli.evaluate

    def recording(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]
    monkeypatch.setattr(eval_cli, "evaluate", recording)
    eval_cli.main(args + ["--version", "0", "--batch_size", "2"])
    assert seen == [val]

    audio = os.path.join(root, "audio")
    wavs = [os.path.join(audio, n) for n in sorted(os.listdir(audio))[:2]]
    by_run = predict_cli.main(wavs + ["--version", "0", "--log_dir",
                                      str(logs), "--device", "cpu"])
    ckpt = ["--torch_ckpt", str(run / "best_model.pt"), *flags,
            "--device", "cpu"]
    by_ckpt = predict_cli.main(wavs + ckpt)
    assert [p.key for p in by_run.values()] \
        == [p.key for p in by_ckpt.values()]
    local = predict_cli.main(wavs + ckpt + ["--local_windows",
                                            "--loc_window_size", "1"])
    assert list(local) == wavs and all(p.windows for p in local.values())
    with pytest.raises(ValueError, match="multi_scale"):
        predict_cli.main(wavs + ["--torch_ckpt", str(run / "best_model.pt"),
                                 *ARCH, "--device", "cpu"])


# ---------------------------------------------------------------------------
# the card's launch accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,want", [
    (dict(multi_scale=True), (14, 2, 6)),
    (dict(multi_scale=True, linear_reg_multi=True, genre=True), (14, 2, 6)),
    (dict(multi_scale=True, resblock=True), (14, 2, 0)),
])
def test_chip_smoke_expected_launches(kw, want):
    """chip_smoke.expected_launches at the default widths, from the
    config: kernel A (octaves - 1) and B once per CQT the model consumes,
    C once per layer of every stack its gate takes, in both towers
    (3 at H = 288 and 3 at H = 96 for the ensemble; none on residual
    stacks). The single-scale variants: tests/test_torch_gate.py."""
    import chip_smoke
    cfg = Config(fused_convstack=True, **kw)
    est = KeyEstimator(cfg, build_model(cfg).state_dict(), device="cpu")
    got = chip_smoke.expected_launches(est)
    assert (got["cascade_pad"], got["octave_response"],
            got["conv7_layer"]) == want
