"""PyTorch port: the residual PitchClassNet variants against the flax
model.

The variants of the matrix (tests/torch_parity.py VARIANTS) whose stacks
are ResBlocks: global mode with and without sequence lengths, local mode
(with the genre head), the weights' conversion and the reference's
`.conv2d.` naming; kernel C never resolved for a res or dense stack; and
the residual model at kernel 7 and the published widths with
fused_convstack on, whose Pitch2Pitch stack resolves the residual conv
kernel and runs it (its plain version on the CPU). Bars: rtol/atol 1e-4
(tests/test_torch_port.py:258, :272).
"""

import functools

import pytest
import torch

from audio_key_estimation_torch.models.blocks import ConvStack
from audio_key_estimation_torch.ops import resstack_cuda as RS
from audio_key_estimation_torch.ops import stack_kernels as SK
from audio_key_estimation_torch.utils.profiling import spans
from torch_parity import (SMALL, assert_forward_matches,
                          assert_reference_loads, assert_state_dict_matches,
                          config_pair, variant_pair)

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
        assert stack.kernel is not SK.CONV7
    assert ConvStack(5, 8, 7, 3, False, g,
                     fused_serving=True).kernel is SK.CONV7


@functools.lru_cache(maxsize=None)
def res_kernel_pair():
    """The resblock model with the Pitch2Pitch stack the residual conv
    kernel is built for: kernel 7, n_filters 4 (stem 5 -> 8, blocks 8 ->
    16 -> 8), conv_layers 3, fused_convstack on."""
    from audio_key_estimation_tpu.config import Config
    return config_pair(Config(**{**SMALL, "kernel_size": 7, "n_filters": 4,
                                 "conv_layers": 3, "resblock": True,
                                 "fused_convstack": True}))


@pytest.mark.parametrize("with_lengths", [False, True])
def test_the_residual_kernel_path_matches_flax(with_lengths):
    pair = res_kernel_pair()
    net = pair[3]
    p2p = net.model[1].p2p
    assert p2p.kernel is SK.RESCONV7 and p2p.cins == [5, 8, 8]
    before = RS.resconv7.launches
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert_forward_matches(pair, with_lengths)
    assert RS.resconv7.launches == before     # the CPU runs no kernel
    stacks = [s for s in spans() if s.name == "akx.stack"]
    assert len(stacks) == 3
    assert sorted(s.counts.get("hand_kernel", -1) for s in stacks) \
        == [-1, -1, 1]
    assert all(s.counts["convs"] == 7 for s in stacks)
