"""PyTorch port: the PitchClassNet variants with plain conv stacks against
the flax model.

The variants of the matrix (tests/torch_parity.py VARIANTS, from
tests/test_torch_port.py:210-222) that keep plain conv stacks: the same
flax-initialized weights (BatchNorm statistics randomized) through the
flax PitchClassNet and the port's, global mode with and without sequence
lengths and, for the default, local mode; the weights' conversion and
the p2pc_conv pool's reference naming. Res/dense variants:
tests/test_torch_blocks.py. Bars: rtol/atol 1e-4
(tests/test_torch_port.py:258, :272).
"""

import pytest

from audio_key_estimation_torch.models import PitchClassNet
from torch_parity import (assert_forward_matches, assert_reference_loads,
                          assert_state_dict_matches, variant_config,
                          variant_pair)

PLAIN = ["default", "p2pc_conv", "pc2p_mem", "stay_sixth", "only_semitones",
         "max_pool", "three_layers"]


@pytest.fixture(scope="module", params=PLAIN)
def pair(request):
    return request.param, variant_pair(request.param)


def test_state_dict_from_jax_equals_torch_port(pair):
    assert_state_dict_matches(pair[1][2])


@pytest.mark.parametrize("with_lengths", [False, True])
def test_forward_matches_flax(pair, with_lengths):
    assert_forward_matches(pair[1], with_lengths)


def test_local_forward_matches_flax():
    """Local mode on the global model's weights: time-major key (sigmoid),
    tonic and genre; T' = 40 - frames * loc_window_size + 1, the genre
    head (no sliding max) 40 - 2 (k - 1)."""
    out = assert_forward_matches(variant_pair("default"), False, local=True)
    assert [tuple(o.shape) for o in out] == [(2, 31, 12), (2, 31, 12),
                                             (2, 36, 11)]


def test_reference_named_loads_p2pc_conv():
    assert_reference_loads(variant_pair("p2pc_conv"), "p2pc_conv")


def test_only_multi_scale_is_refused():
    """PitchClassNet refuses multi_scale (the ensemble's job, named in the
    error) and builds every other variant."""
    with pytest.raises(ValueError, match="PitchClassNetMulti"):
        PitchClassNet(variant_config("default").replace(multi_scale=True))
    for field in ("resblock", "denseblock", "p2pc_conv", "pc2p_mem",
                  "stay_sixth", "only_semitones", "max_pool", "local",
                  "genre"):
        PitchClassNet(variant_config("default").replace(**{field: True}))
