"""PyTorch port: the residual PitchClassNet variants against the flax
model.

The variants of the matrix (tests/torch_parity.py VARIANTS) whose stacks
are ResBlocks: global mode with and without sequence lengths, local mode
(with the genre head), the weights' conversion and the reference's
`.conv2d.` naming; kernel C's gate refusing res and dense stacks. Bars:
rtol/atol 1e-4 (tests/test_torch_port.py:258, :272).
"""

import pytest
import torch

from audio_key_estimation_torch.models.blocks import ConvStack
from torch_parity import (assert_forward_matches, assert_reference_loads,
                          assert_state_dict_matches, variant_pair)

VARIANT_NAMES = ["resblock", "resblock_pc2p_mem"]
LOCAL = "resblock"


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


def test_block_stacks_refuse_kernel_c():
    """Kernel C's gate takes no res or dense stack, whatever its widths
    (the JAX gate, models/blocks.py:306-308)."""
    g = torch.Generator().manual_seed(0)
    for kw in (dict(resblock=True), dict(denseblock=True)):
        stack = ConvStack(5, 8, 7, 3, False, g, fused_serving=True,
                          **kw).eval()
        assert not stack.fusable
        assert not stack.use_fused(torch.zeros(1, 5, 12, 6))
    assert ConvStack(5, 8, 7, 3, False, g, fused_serving=True).fusable
