"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

One set of weights for both frameworks: flax `init` of the JAX model with
its BatchNorm statistics randomized (so eval-mode normalization is not the
identity), returned as numpy trees the port loads through
`models.convert.state_dict_from_jax`.
"""

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
