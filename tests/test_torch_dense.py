"""PyTorch port: the dense PitchClassNet variants against the flax model.

The variants of the matrix (tests/torch_parity.py VARIANTS) whose stacks
are DenseBlocks: global mode with and without sequence lengths, local
mode (with the genre head), the weights' conversion and the reference's
`.conv2d.` naming; and the multi-path dense block at block level
(tests/test_torch_port.py:308). Bars: rtol/atol 1e-4
(tests/test_torch_port.py:258, :272).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from audio_key_estimation_tpu.models.blocks import DenseBlock as JaxDense

from audio_key_estimation_torch.models.blocks import DenseBlock
from audio_key_estimation_torch.models.convert import (load_state_dict,
                                                       state_dict_from_jax)
from torch_parity import (assert_forward_matches, assert_reference_loads,
                          assert_state_dict_matches, variant_pair)

VARIANT_NAMES = ["denseblock", "dense_p2pc_conv"]
LOCAL = "denseblock"


@pytest.fixture(scope="module", params=VARIANT_NAMES)
def pair(request):
    return variant_pair(request.param)


def test_state_dict_from_jax_equals_torch_port(pair):
    assert_state_dict_matches(pair[2])


@pytest.mark.parametrize("with_lengths", [False, True])
def test_forward_matches_flax(pair, with_lengths):
    assert_forward_matches(pair, with_lengths)


def test_local_forward_matches_flax():
    out = assert_forward_matches(variant_pair(LOCAL), False, local=True)
    assert [tuple(o.shape) for o in out] == [(2, 31, 12), (2, 31, 12),
                                             (2, 36, 11)]


def test_reference_named_loads():
    assert_reference_loads(variant_pair(LOCAL), LOCAL)


def test_dense_multi_path_block_parity(rng):
    """multi_path dense block (kernel 3, 5, 7 per layer) at block level,
    as tests/test_torch_port.py:308 (the full net never enables it)."""
    block = JaxDense(num_layers=3, in_ch=4, bn_size=2, growth=4,
                     kernel_size=7, equivariant=True, multi_path=True)
    x = rng.normal(size=(2, 12, 20, 4)).astype(np.float32)
    variables = block.init(jax.random.PRNGKey(0), jnp.asarray(x), False)
    flat = traverse_util.flatten_dict(variables["batch_stats"])
    for k in flat:
        flat[k] = jnp.asarray(rng.uniform(0.5, 2.0, flat[k].shape)
                              if k[-1] == "var"
                              else rng.normal(size=flat[k].shape) * 0.3,
                              jnp.float32)
    variables = {"params": variables["params"],
                 "batch_stats": traverse_util.unflatten_dict(flat)}
    out_j = block.apply(variables, jnp.asarray(x), False)

    port = DenseBlock(3, 4, 2, 4, 7, True, torch.Generator().manual_seed(0),
                      multi_path=True)
    assert [m.conv2.conv2d.weight.shape[3] for m in port.children()] == \
        [3, 5, 7]
    load_state_dict(port, state_dict_from_jax(variables))
    with torch.no_grad():
        out_t = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out_t.permute(0, 2, 3, 1).numpy(),
                               np.asarray(out_j), rtol=1e-4, atol=1e-4)
