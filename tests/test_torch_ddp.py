"""PyTorch port: data-parallel training against the JAX package's sharded
mesh, on the CPU.

The port's ranks are processes spawned with gloo on a file:// store
(tests/torch_dp_workers.py); the JAX side runs its train step over the
8-device CPU mesh (tests/conftest.py) and on one device. One spawn per
world size (2 and 4) runs every case of a file, and its tests read the
results (the local and multi-scale programs are
tests/test_torch_ddp_programs.py's):
 * one train step at micro-batch 8 x acc_grad 2 (tests/test_train.py:84-113
   geometry) of the global program (genre on): loss rtol 1e-5,
   parameters within 2.1 x lr, BatchNorm running statistics rtol 1e-6
   (atol 1e-7 for means near 0) of the JAX sharded and single-device
   steps computing in float64 (the JAX float32 step drifts:
   test_torch_multi_scale.py) and of the port's single-process step,
   and every rank's gradients and parameters equal to every other's, bit
   for bit;
 * the same step with the port computing in float64 (Config.dtype,
   weights and batch): each gradient within 1e-4 of its tensor's largest
   magnitude plus 1e-5 of the model's largest gradient
   (tests/test_torch_train.py's bar) of the JAX float64 gradients (read
   from the optimizer's input) and of the port's single process. Not in
   float32: there the world-2 and single-process gradients of the
   ensemble's model1 layer 0 differ by 1.4e-4 of the model's largest
   gradient, and in float64 by 2e-9, as where a rounding of the global
   BatchNorm statistics moves a leaky-ReLU input across 0;
 * the global step's genre labels sit unevenly over the shards (world 2:
   3 and 1; world 4: 2, 1, 1 and none), so a per-rank mean averaged over
   the ranks would miss the global loss; `loss_share` is also checked
   directly against that per-rank mean;
 * a step with dropout (dense blocks, drop 0.3) against the port's
   single-process step: the masks are the global micro-batch's;
 * steps under remat (the global program, and dense blocks with
   dropout) against the port's single-process remat step: the
   recomputation in the backward pass takes the global BatchNorm
   statistics and the global dropout masks again, its all-reduces
   interleaved with DDP's;
 * evaluate over 35 songs at batch 8 (5 batches, more than
   MAX_INFLIGHT, 5 repeat-padded rows; every third song genre-labelled)
   against the JAX evaluate over make_mesh() (tests/test_train.py:141-160
   bars: rtol 1e-4, atol 1e-5).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audio_key_estimation_tpu.config import Config as JaxConfig
from audio_key_estimation_tpu.models import PitchClassNet as JaxNet
from audio_key_estimation_tpu.models.multi_scale import \
    PitchClassNetMulti as JaxMulti
from audio_key_estimation_tpu.models.torch_port import state_dict_to_variables
from audio_key_estimation_tpu.parallel import mesh as jax_mesh
from audio_key_estimation_tpu.train import trainer as jax_trainer
from audio_key_estimation_tpu.train.optim import make_optimizer as jax_optim

from audio_key_estimation_torch.config import Config
from audio_key_estimation_torch.models import build_model
from audio_key_estimation_torch.models.convert import (match_names,
                                                       state_dict_from_jax)
from audio_key_estimation_torch.train import loss as port_loss

import torch_dp_workers as W

GEOM = dict(octaves=4, num_layers=2, conv_layers=1, n_filters=2,
            kernel_size=3, head_layers=1, batch_size=8, acc_grad=2,
            frames=5, loc_window_size=2, bucket_sizes=(32,),
            cqt_conv_dtype="float32")
PROGRAMS = {"global": dict(genre=True),
            "local": dict(genre=True, local=True),
            "multi_scale": dict(multi_scale=True)}
T = 32
# shard imbalance: the micro-batch rows that carry a genre label
GENRE_ROWS = (0, 1, 2, 5)
GENRE_SCALE = 30.0
DENSE = dict(GEOM, denseblock=True, drop=0.3)
# cases held against the port's single-process step alone (the JAX
# dropout masks are other bits): Config fields, dropout seed
PORT_CASES = {"dropout": (DENSE, 3),
              "remat": (dict(GEOM, **PROGRAMS["global"], remat=True), 0),
              "remat_dropout": (dict(DENSE, remat=True), 3)}
EVAL_SONGS = 35
WORLDS = (2, 4)
F64 = jnp.float64
F64T = torch.float64


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64)
        if np.asarray(a).dtype == np.float32 else np.asarray(a), tree)


def _f32(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        if np.asarray(a).dtype == np.float64 else np.asarray(a), tree)


def _batch(cfg: Config, rng, windows: int = 0) -> dict:
    """One stacked (acc_grad, 8, ...) batch; rows of differing length;
    genre labels on GENRE_ROWS only; per-window labels in local mode."""
    acc, bs = cfg.acc_grad, cfg.batch_size
    seq = rng.integers(T // 2, T + 1, (acc, bs)).astype(np.int32)
    mel = rng.normal(size=(acc, bs, cfg.pitches, T, 1)).astype(np.float32)
    mel *= (np.arange(T) < seq[..., None])[:, :, None, :, None]
    genre = np.zeros((acc, bs, 11), np.float32)
    genre[:, list(GENRE_ROWS), rng.integers(0, 11, len(GENRE_ROWS))] = 1
    shape = (acc, bs, windows) if windows else (acc, bs)
    b = {"mel": mel, "seq_length": seq, "genre": genre,
         "key_labels": np.eye(12, dtype=np.float32)[
             rng.integers(0, 12, shape)],
         "tonic_labels": np.eye(12, dtype=np.float32)[
             rng.integers(0, 12, shape)]}
    if cfg.multi_scale:
        b["mel2"] = rng.normal(size=(acc, bs, cfg.octaves * 12, T, 1)
                               ).astype(np.float32)
    return b


@functools.lru_cache(maxsize=None)
def inputs(name: str):
    """(port cfg, JAX cfg, JAX model, the JAX variables, the port's weights
    as numpy, one batch) of a program: the port's initial weights (seed
    cfg.seed; the genre head scaled by GENRE_SCALE) carried into the JAX
    model's variables by its own torch_port.state_dict_to_variables."""
    kw = {**GEOM, **PROGRAMS[name]}
    cfg_j, cfg = JaxConfig(**kw), Config(**kw)
    net = build_model(cfg)
    if cfg.genre:
        # a genre head whose logits vary from row to row, so the genre
        # term's mean depends on which rows it is taken over
        with torch.no_grad():
            for p in net.genre_classifier.parameters():
                p.mul_(GENRE_SCALE)
    weights = W.numpy_state(net)
    if cfg.multi_scale:
        model = JaxMulti(cfg_j)
        args = (jnp.zeros((1, cfg.pitches, 64, 1)),
                jnp.zeros((1, cfg.octaves * 12, 64, 1)))
    else:
        model = JaxNet(cfg_j)
        args = (jnp.zeros((1, cfg.pitches, 64, 1)),)
    template = jax.eval_shape(lambda k: model.init(k, *args, None, False),
                              jax.random.PRNGKey(0))
    variables = state_dict_to_variables(weights, template)
    windows = 0
    if cfg.local:
        with torch.no_grad():
            windows = net.eval()(torch.zeros(1, cfg.pitches, T, 1))[0]\
                .shape[1]
    batch = _batch(cfg, np.random.default_rng(len(name)), windows)
    return cfg, cfg_j, model, variables, weights, batch


def recording(optimizer):
    """`optimizer` that also keeps the gradients it was given in its
    state: (inner state, last gradients)."""
    def init(params):
        return optimizer.init(params), jax.tree_util.tree_map(jnp.zeros_like,
                                                              params)

    def update(grads, state, params=None):
        updates, inner = optimizer.update(grads, state[0], params)
        return updates, (inner, grads)
    return optax.GradientTransformation(init, update)


@functools.lru_cache(maxsize=None)
def jax_step(name: str) -> dict:
    """The JAX step from the program's weights on its batch, computing in
    float64, sharded over the 8-device mesh ("mesh") and on one device
    ("single"): its loss, the state after it and the averaged gradients
    its optimizer took, under the port's names."""
    cfg, cfg_j, _, variables, weights, batch = inputs(name)
    model64 = (JaxMulti if cfg.multi_scale else JaxNet)(cfg_j, dtype=F64)
    optimizer = recording(jax_optim(cfg_j, 1))
    net = build_model(cfg)
    param_names = {k for k, _ in net.named_parameters()}

    def fresh():   # the step donates its state
        params = jax.tree_util.tree_map(jnp.asarray,
                                        _f64(variables["params"]))
        return jax_trainer.TrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=jax.tree_util.tree_map(
                jnp.asarray, _f64(variables["batch_stats"])),
            opt_state=optimizer.init(params))
    step = jax_trainer.make_train_step(model64, cfg_j, optimizer, seed=0)
    b64 = _f64(batch)
    mesh = jax_mesh.make_mesh()
    runs = {"mesh": step(jax_mesh.replicate(fresh(), mesh),
                         jax_mesh.shard_batch(b64, mesh, batch_dim=1)),
            "single": step(fresh(), b64)}
    out = {}
    for tag, (s, m) in runs.items():
        exported = state_dict_from_jax(_f32({"params": s.params,
                                             "batch_stats": s.batch_stats}))
        names = match_names(net.state_dict(), exported)
        grads = state_dict_from_jax(_f32({"params": s.opt_state[1]}))
        out[tag] = {"loss": float(m["loss"]),
                    "state": {k: exported[v] for k, v in names.items()},
                    "grads": {k: grads[v] for k, v in names.items()
                              if k in param_names}}
    return out


@functools.lru_cache(maxsize=None)
def port_case(name: str):
    """(cfg, numpy weights, one batch, dropout seed) of a PORT_CASES
    case: the global program's weights and batch, or, with dense blocks,
    the seeded model's weights and a batch of its own."""
    fields, seed = PORT_CASES[name]
    cfg = Config(**fields)
    if not cfg.denseblock:
        return (cfg, *inputs("global")[4:], seed)
    weights = W.numpy_state(build_model(cfg))
    return cfg, weights, _batch(cfg, np.random.default_rng(5)), seed


@functools.lru_cache(maxsize=None)
def jax_evaluate() -> dict:
    """The JAX evaluate over make_mesh() on 35 synthetic songs, every
    third genre-labelled, with the global program's weights."""
    cfg, cfg_j, model, variables, _, _ = inputs("global")
    optimizer = jax_optim(cfg_j, 1)
    state = jax_trainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=optimizer.init(variables["params"]))
    mesh = jax_mesh.make_mesh()
    ds = W.synthetic_dataset(cfg, EVAL_SONGS, 11, genre_every=3)
    return jax_trainer.evaluate(jax_trainer.make_eval_step(model, cfg_j),
                                jax_mesh.replicate(state, mesh), ds,
                                cfg.batch_size, mesh=mesh)


def case(name: str, dtype: torch.dtype = torch.float32) -> tuple:
    """(cfg, numpy weights, batch, dropout seed, dtype) of a program or a
    PORT_CASES case, computing in `dtype` (Config.dtype too)."""
    if name in PORT_CASES:
        cfg, weights, batch, seed = port_case(name)
    else:
        cfg, _, _, _, weights, batch = inputs(name)
        seed = 0
    if dtype != torch.float32:
        cfg = cfg.replace(dtype=dtype)
    return cfg, weights, batch, seed, dtype


@functools.lru_cache(maxsize=None)
def single_step(name: str, dtype: torch.dtype = torch.float32) -> dict:
    """The port's single-process step of case(name, dtype)."""
    return W.single_step(*case(name, dtype))


def run_ranks(tmp_path_factory, names, evaluate: bool = False) -> dict:
    """{world: each rank's {case name: result}} for one train step of each
    program or PORT_CASES case in `names`, computing in float32 (under
    the name) and in float64 (under name + "/f64"), and the sharded
    evaluate. Both worlds' ranks start together and run while the JAX
    side compiles."""
    cases = [case(n) for n in names] + [case(n, F64T) for n in names]
    keys = list(names) + [n + "/f64" for n in names]
    jobs = [(W.dp_train_steps, (cases,))]
    if evaluate:
        jobs.append((W.dp_evaluate, (inputs("global")[0],
                                     inputs("global")[4], EVAL_SONGS, 11, 3)))
        keys.append("evaluate")
    started = {w: W.Ranks(W.run_jobs, w, tmp_path_factory.mktemp("dp"), jobs)
               for w in WORLDS}
    for n in names:
        if n not in PORT_CASES:
            jax_step(n)
    if evaluate:
        jax_evaluate()
    out = {}
    for w, r in started.items():
        out[w] = [dict(zip(keys, res[0] + res[1:])) for res in r.results()]
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(tmp_path_factory, ("global", *PORT_CASES),
                     evaluate=True)


def assert_grads_close(got: dict, want: dict) -> None:
    """Each gradient within 1e-4 of its tensor's largest magnitude plus
    1e-5 of the model's largest gradient (tests/test_torch_train.py's
    bar)."""
    assert got.keys() == want.keys()
    top = max(float(np.abs(v).max()) for v in want.values())
    for k, v in want.items():
        d = float(np.abs(got[k] - v).max())
        assert d <= 1e-4 * float(np.abs(v).max()) + 1e-5 * top, (k, d)


def _check_step(got: dict, loss: float, state: dict, lr: float,
                buffers_rtol: float = 1e-6):
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
    for k, p in got["params"].items():
        d = float(np.abs(p - state[k]).max())
        # Adam's first update is ~lr * sign(g): a gradient at the
        # rounding floor may flip its sign (tests/test_train.py:108-113)
        assert d <= 2.1 * lr, (k, d)
    for k, b in got["buffers"].items():
        np.testing.assert_allclose(b, state[k], rtol=buffers_rtol, atol=1e-7,
                                   err_msg=k)


def check_against_jax(ranks, world, name, against):
    """Every rank's step against the JAX step (float64): in float32, loss
    rtol 1e-5, parameters 2.1 x lr, BatchNorm running statistics rtol
    1e-6; in float64, the gradients at assert_grads_close's bar."""
    cfg = inputs(name)[0]
    ref = jax_step(name)[against]
    for r in ranks[world]:
        _check_step(r[name], ref["loss"], ref["state"], cfg.lr)
        assert_grads_close(r[name + "/f64"]["grads"], ref["grads"])


def check_ranks_agree(ranks, world, name):
    """Every rank ends the step with the same gradients, parameters and
    buffers and reads the same global loss, in float32 and float64."""
    for key in (name, name + "/f64"):
        first = ranks[world][0][key]
        for r in ranks[world][1:]:
            got = r[key]
            assert got["loss"] == first["loss"]
            for part in ("grads", "params", "buffers"):
                for k, v in first[part].items():
                    np.testing.assert_array_equal(got[part][k], v,
                                                  err_msg=f"{part} {k}")


def check_against_single_process(ranks, world, name):
    """Every rank against the port's own single-process step on the same
    rows: in float32, loss rtol 1e-5, parameters 2.1 x lr, running
    statistics rtol 1e-6; in float64, the gradients at
    assert_grads_close's bar."""
    cfg = case(name)[0]
    ref, ref64 = single_step(name), single_step(name, F64T)
    for r in ranks[world]:
        _check_step(r[name], ref["loss"],
                    {**ref["params"], **ref["buffers"]}, cfg.lr)
        assert_grads_close(r[name + "/f64"]["grads"], ref64["grads"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("against", ["mesh", "single"])
def test_sharded_step_matches_jax(ranks, world, against):
    """The global program (genre labels uneven over the shards) against
    the JAX step over the 8-device mesh and on one device."""
    check_against_jax(ranks, world, "global", against)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["global", *PORT_CASES])
def test_ranks_agree_bit_for_bit(ranks, world, name):
    check_ranks_agree(ranks, world, name)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["global", *PORT_CASES])
def test_sharded_step_matches_single_process(ranks, world, name):
    """With dropout on (dense blocks, drop 0.3) the masks are those of the
    global micro-batch, so the step is the single process's; under remat
    the recomputation takes the global statistics and masks again."""
    check_against_single_process(ranks, world, name)


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["train", "eval_weights"])
@pytest.mark.parametrize("world", WORLDS)
def test_loss_shares_add_up_where_a_per_rank_mean_does_not(world, weighted):
    """The global program's batch gives the ranks different counts of
    genre-labelled rows (and, with eval-style sample weights, of valid
    rows): the shares of loss_share over the global loss_totals add up to
    compute_loss of the whole micro-batch (rtol 1e-6), where a per-rank
    mean averaged over the ranks misses it by more than 1e-3."""
    cfg, _, _, _, weights, batch = inputs("global")
    net = build_model(cfg)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    net.train()     # BatchNorm by batch statistics: rows differ
    micro = {k: torch.from_numpy(v[0]) for k, v in batch.items()}
    w = (torch.tensor([1, 1, 1, 1, 1, 0, 0, 0], dtype=torch.float32)
         if weighted else None)
    k = cfg.batch_size // world
    rows = [slice(r * k, (r + 1) * k) for r in range(world)]
    with torch.no_grad():
        out = net(micro["mel"], micro["seq_length"])
        want, _ = port_loss.compute_loss(cfg, out, micro, w)
        shards = [{n: v[s] for n, v in micro.items()} for s in rows]
        outs = [tuple(o[s] for o in out) for s in rows]
        ws = [None if w is None else w[s] for s in rows]
        counts = [int((sh["genre"].sum(1) == 1).sum()) for sh in shards]
        assert len(set(counts)) > 1, counts
        totals = sum(port_loss.loss_totals(cfg, sh, sw)
                     for sh, sw in zip(shards, ws))
        shares = [port_loss.loss_share(cfg, o, sh, totals, sw)
                  for o, sh, sw in zip(outs, shards, ws)]
        per_rank = sum(port_loss.compute_loss(cfg, o, sh, sw)[0]
                       for o, sh, sw in zip(outs, shards, ws)) / world
    np.testing.assert_allclose(float(sum(shares)), float(want), rtol=1e-6)
    assert abs(float(per_rank) - float(want)) > 1e-3, (per_rank, want)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_evaluate_matches_jax_mesh(ranks, world):
    """evaluate(sharded=True) over 35 songs at batch 8 on every rank
    against the JAX evaluate over the 8-device mesh: every aggregate
    within rtol 1e-4, atol 1e-5, 35 samples."""
    ref = jax_evaluate()
    for r in ranks[world]:
        got = r["evaluate"]
        assert got["num_samples"] == ref["num_samples"] == EVAL_SONGS
        assert got.keys() == ref.keys()
        for k, v in ref.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-5,
                                       err_msg=k)
