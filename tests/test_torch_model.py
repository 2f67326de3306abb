"""PyTorch port: PitchClassNet and weight conversion against the JAX model.

The same flax-initialized weights (BatchNorm statistics randomized) run
through the flax PitchClassNet and the port's, at a tiny configuration;
bars from tests/test_torch_port.py:171-176.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_key_estimation_tpu.config import Config
from audio_key_estimation_tpu.models.torch_port import variables_to_state_dict

from audio_key_estimation_torch.models import PitchClassNet
from audio_key_estimation_torch.models.convert import (load_state_dict,
                                                       state_dict_from_jax)
from torch_parity import jax_variables

CFG = Config(octaves=4, num_layers=2, conv_layers=2, n_filters=4,
             kernel_size=7, head_layers=2)


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "genre"])
def pair(request):
    cfg = CFG.replace(genre=request.param)
    model, variables = jax_variables(cfg, np.random.default_rng(1))
    net = PitchClassNet(cfg)
    load_state_dict(net, state_dict_from_jax(variables))
    return cfg, model, variables, net.eval()


def test_state_dict_from_jax_equals_torch_port(pair):
    _, _, variables, _ = pair
    ref = variables_to_state_dict(variables)
    got = state_dict_from_jax(variables)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)


@pytest.mark.parametrize("with_lengths", [False, True])
def test_forward_matches_flax(pair, with_lengths):
    cfg, model, variables, net = pair
    rng = np.random.default_rng(2)
    mel = rng.normal(size=(2, cfg.pitches, 40, 1)).astype(np.float32)
    seq = np.array([40, 27], np.int32) if with_lengths else None
    out_j = model.apply(variables, jnp.asarray(mel),
                        None if seq is None else jnp.asarray(seq), False)
    with torch.no_grad():
        out_t = net(torch.from_numpy(mel),
                    None if seq is None else torch.from_numpy(seq))
    assert len(out_t) == (3 if cfg.genre else 2)
    np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]),
                               rtol=1e-4, atol=1e-5)
    for j, t in zip(out_j[1:], out_t[1:]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-4)


def _blob_input(rng, pitches, t, guard):
    mel = np.zeros((1, pitches, t, 1), np.float32)
    lo = guard
    mel[0, lo + 20:lo + 60, 5:40, 0] = rng.random((40, 35)).astype(np.float32)
    mel[0, lo + 5:lo + 8, 45:60, 0] = 3.0
    return mel


@pytest.mark.parametrize("shift_semitones", [1, 3, 12])
def test_transposition_equivariance(shift_semitones):
    """As tests/test_model.py:151: shifting the input by n semitones
    rolls key and tonic by n."""
    cfg = Config(octaves=5, num_layers=2, conv_layers=2, n_filters=4,
                 kernel_size=7, head_layers=2)
    rng = np.random.default_rng(0)
    mel = _blob_input(rng, cfg.pitches, 64, 36)
    net = PitchClassNet(cfg, generator=torch.Generator().manual_seed(1))
    net.eval()
    with torch.no_grad():
        key0, tonic0 = net(torch.from_numpy(mel))
        shifted = np.roll(mel, 3 * shift_semitones, axis=1)
        key1, tonic1 = net(torch.from_numpy(shifted))
    np.testing.assert_allclose(np.roll(key0.numpy(), shift_semitones, 1),
                               key1.numpy(), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.roll(tonic0.numpy(), shift_semitones, 1),
                               tonic1.numpy(), rtol=2e-4, atol=2e-5)


def test_reference_key_naming_loads(pair):
    """A reference checkpoint nests equivariant convs as `.conv2d.` and
    carries num_batches_tracked: the port's own state_dict keys are that
    naming, and both forms load strictly."""
    cfg, _, variables, net = pair
    sd = state_dict_from_jax(variables)
    own = net.state_dict()
    assert "model.0.pc2pc.layer.0.conv2d.weight" in own
    assert "model.1.p2p.layer.0.weight" in own
    assert "key_classifier.3.conv2d.weight" in own
    assert not any(k.endswith("num_batches_tracked") for k in own)
    reference = {k: torch.from_numpy(np.array(v)) for k, v in own.items()}
    reference["model.0.pool_semi_b.num_batches_tracked"] = torch.tensor(7)
    other = PitchClassNet(cfg)
    load_state_dict(other, reference)
    for k, v in other.state_dict().items():
        assert torch.equal(v, own[k]), k
    # plain torch load of the reference file, num_batches_tracked dropped
    other.load_state_dict({k: v for k, v in reference.items()
                           if not k.endswith("num_batches_tracked")},
                          strict=True)
    with pytest.raises(KeyError, match="missing"):
        load_state_dict(other, {k: v for k, v in sd.items()
                                if "up_sixth" not in k})
    with pytest.raises(KeyError, match="unexpected"):
        load_state_dict(other, dict(sd, stray=np.zeros(1)))


@pytest.mark.parametrize("field", ["multi_scale"])
def test_unported_variants_raise(field):
    """PitchClassNet refuses a multi-scale Config (it would be one tower of
    the ensemble), naming PitchClassNetMulti, which build_model builds."""
    from audio_key_estimation_torch.models import (PitchClassNetMulti,
                                                   build_model)
    cfg = CFG.replace(**{field: True})
    with pytest.raises(ValueError, match="PitchClassNetMulti"):
        PitchClassNet(cfg)
    assert isinstance(build_model(cfg), PitchClassNetMulti)


def test_seeded_init_is_deterministic():
    a = PitchClassNet(CFG, generator=torch.Generator().manual_seed(0))
    b = PitchClassNet(CFG, generator=torch.Generator().manual_seed(0))
    c = PitchClassNet(CFG, generator=torch.Generator().manual_seed(1))
    w = "model.1.p2p.layer.0.weight"
    assert torch.equal(a.state_dict()[w], b.state_dict()[w])
    assert not torch.equal(a.state_dict()[w], c.state_dict()[w])
    # torch Conv2d default bound 1/sqrt(fan_in)
    fan_in = 5 * 7 * 7
    assert a.state_dict()[w].abs().max() <= 1 / np.sqrt(fan_in)
