"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

One set of weights for both frameworks: flax `init` of the JAX model with
its BatchNorm statistics randomized (so eval-mode normalization is not the
identity), returned as numpy trees the port loads through
`models.convert.state_dict_from_jax`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from flax import traverse_util

from audio_key_estimation_tpu.models import PitchClassNet as JaxNet


def jax_variables(cfg, rng, seed=3, time_frames=32):
    """(flax model, variables as nested numpy dicts) for `cfg`."""
    model = JaxNet(cfg)
    mel = jnp.zeros((1, cfg.pitches, time_frames, 1), jnp.float32)
    variables = model.init(jax.random.PRNGKey(seed), mel, None, False)
    flat = traverse_util.flatten_dict(variables["batch_stats"])
    for k in flat:
        if k[-1] == "mean":
            flat[k] = rng.normal(size=flat[k].shape) * 0.3
        else:
            flat[k] = rng.uniform(0.5, 2.0, flat[k].shape)
        flat[k] = flat[k].astype(np.float32)
    variables = {"params": variables["params"],
                 "batch_stats": traverse_util.unflatten_dict(flat)}
    return model, jax.tree_util.tree_map(np.asarray, variables)


# The variant matrix of tests/test_torch_port.py:210-222 at its small
# configuration (:225-229), for the port's variant tests
# (tests/test_torch_variants.py, tests/test_torch_blocks.py).
VARIANTS = {
    "default": dict(),
    "resblock": dict(resblock=True),
    "denseblock": dict(denseblock=True),
    "p2pc_conv": dict(p2pc_conv=True),
    "pc2p_mem": dict(pc2p_mem=True),
    "stay_sixth": dict(stay_sixth=True),
    "only_semitones": dict(only_semitones=True),
    "max_pool": dict(max_pool=True),
    "three_layers": dict(num_layers=3, conv_layers=1),
    "resblock_pc2p_mem": dict(resblock=True, pc2p_mem=True),
    "dense_p2pc_conv": dict(denseblock=True, p2pc_conv=True),
}
SMALL = dict(octaves=4, num_layers=2, conv_layers=2, n_filters=4,
             kernel_size=3, head_layers=2, genre=True, frames=5,
             loc_window_size=2)


def variant_config(name: str):
    from audio_key_estimation_tpu.config import Config
    return Config(**{**SMALL, **VARIANTS[name]})


@functools.lru_cache(maxsize=None)
def variant_pair(name: str, seed: int = 7):
    """(cfg, flax model, numpy variables, the port's model loaded with
    them in eval mode) for one variant of the matrix; built once per
    process (flax's eager init compiles every op on first use)."""
    return config_pair(variant_config(name), seed)


def config_pair(cfg, seed: int = 7):
    """variant_pair for any JAX Config."""
    import torch  # noqa: F401  (the port's model below is torch)
    from audio_key_estimation_torch.models import PitchClassNet
    from audio_key_estimation_torch.models.convert import (
        load_state_dict, state_dict_from_jax)
    model, variables = jax_variables(cfg, np.random.default_rng(seed))
    net = PitchClassNet(cfg)
    load_state_dict(net, state_dict_from_jax(variables))
    return cfg, model, variables, net.eval()


def assert_state_dict_matches(variables):
    """state_dict_from_jax gives variables_to_state_dict's keys and
    arrays exactly."""
    from audio_key_estimation_tpu.models.torch_port import (
        variables_to_state_dict)
    from audio_key_estimation_torch.models.convert import state_dict_from_jax
    ref = variables_to_state_dict(variables)
    got = state_dict_from_jax(variables)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)


def assert_forward_matches(pair, with_lengths: bool, local: bool = False):
    """The port's forward against flax on one seeded (2, pitches, 40, 1)
    input, global mode with or without lengths, or local mode (the same
    weights); rtol/atol 1e-4 (tests/test_torch_port.py:258, :272).
    Returns the port's outputs."""
    import torch
    from audio_key_estimation_tpu.models import PitchClassNet as JaxNet
    from audio_key_estimation_torch.models import PitchClassNet
    cfg, model, variables, net = pair
    mel = np.random.default_rng(2).normal(
        size=(2, cfg.pitches, 40, 1)).astype(np.float32)
    seq = np.array([40, 31], np.int32) if with_lengths else None
    if local:
        model = JaxNet(cfg.replace(local=True))
        weights = net.state_dict()
        net = PitchClassNet(cfg.replace(local=True))
        net.load_state_dict(weights)
        net.eval()
    out_j = model.apply(variables, jnp.asarray(mel),
                        None if seq is None else jnp.asarray(seq), False)
    with torch.no_grad():
        out_t = net(torch.from_numpy(mel),
                    None if seq is None else torch.from_numpy(seq))
    assert len(out_t) == len(out_j) == (3 if cfg.genre else 2)
    for j, t in zip(out_j, out_t):
        assert tuple(t.shape) == tuple(j.shape)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-4)
    return out_t


# a weight the port nests under the reference's module name (`.conv2d.`
# for an equivariant conv, `.conv.` for the p2pc_conv pool), per variant
NESTED_KEY = {
    "resblock": "model.1.pc2pc.layer.3.conv1.conv2d.weight",
    "denseblock": "model.1.pc2pc.layer.0.denselayer1.conv1.conv2d.weight",
    "p2pc_conv": "model.1.pool.conv.weight",
}


def assert_reference_loads(pair, name: str):
    """A reference checkpoint nests equivariant convs as `.conv2d.` and
    the p2pc_conv pool's conv as `.conv.`, and carries
    num_batches_tracked: the port's own keys are that naming, and both it
    and the export's plain naming load strictly to the same weights."""
    import pytest
    import torch
    from audio_key_estimation_torch.models import PitchClassNet
    from audio_key_estimation_torch.models.convert import (
        load_state_dict, state_dict_from_jax)
    cfg, _, variables, net = pair
    exported = state_dict_from_jax(variables)
    own = net.state_dict()
    nested = NESTED_KEY[name]
    plain = nested.replace(".conv2d.", ".").replace(".conv.", ".")
    assert nested in own and nested not in exported and plain in exported
    reference = {k: torch.from_numpy(np.array(v)) for k, v in own.items()}
    reference["model.1.p2p.layer.1.num_batches_tracked"] = torch.tensor(3)
    other = PitchClassNet(cfg)
    load_state_dict(other, reference)
    for k, v in other.state_dict().items():
        assert torch.equal(v, own[k]), k
    with pytest.raises(KeyError, match="missing"):
        load_state_dict(other, {k: v for k, v in exported.items()
                                if k != plain})
