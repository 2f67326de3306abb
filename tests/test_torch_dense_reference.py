"""PyTorch port: the dense-stack configuration (`pcn_denseblock`) against
the benchmark's plain reference of it (`benchmark/reference/dense.py`).

The reference is plain PyTorch that imports nothing of the port, so these
tests hold the port to an independent model: the layout of its state
dict, its eval outputs on seeded weights with calibrated BatchNorm
statistics (at a tiny size and at the published widths on one short
clip), its training-mode outputs and statistics, and its FLOPs at one
180 s clip. Bars: key rtol 1e-4 / atol 1e-5, tonic 1e-4, the repo's
float32 bars for the model's logits (tests/test_torch_port.py:258).
"""

import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from audio_key_estimation_torch.config import Config
from audio_key_estimation_torch.models import build_model
from audio_key_estimation_torch.models.blocks import BatchNorm
from audio_key_estimation_torch.models.convert import load_state_dict

REPO = Path(__file__).resolve().parent.parent
CONFIG = REPO / "benchmark" / "configs" / "pcn_denseblock.json"
SR, HOP = 22050, 4410
# Config fields of a tiny dense model, or the published ones
SIZES = {"tiny": dict(octaves=4, n_filters=2, conv_layers=2, kernel_size=3,
                      head_layers=1),
         "published": {}}


def cfg_of(**fields) -> dict:
    """The configuration as the reference reads it (Context.model)."""
    m = dict(json.loads(CONFIG.read_text())["model"], **fields)
    return dict(m, reference="dense", bins_per_octave=36,
                cqt_stream_dtype="bfloat16", stack_dtype="float32")


def dense():
    from benchmark.reference import dense as ref_dense
    return ref_dense


def system(cfg: dict, sd=None):
    fields = {k: v for k, v in cfg.items()
              if k not in ("reference", "bins_per_octave",
                           "cqt_stream_dtype", "stack_dtype")}
    model = build_model(Config(**fields, fused_convstack=True))
    if sd is not None:
        load_state_dict(model, sd)
    return model


def mels(cfg, n, seconds, seed):
    """n seeded log1p-CQTs of `seconds` s clips, each 101 samples shorter
    than the last, and their true lengths."""
    from benchmark.reference import cqt as ref_cqt
    from benchmark.traffic import synth
    lengths = [seconds * SR - 101 * i for i in range(n)]
    y = synth.pcm16_batch(lengths, seconds * SR, SR, seed, "cpu")
    seq = torch.tensor([1 + k // HOP for k in lengths])
    return [ref_cqt.cqt(y, sr=SR, hop=HOP, bins_per_octave=36,
                        octaves=cfg["octaves"])], seq


def calibrated(cfg):
    ref = dense()
    sd = ref.init_weights(cfg, 11, "cpu")
    m, seq = mels(cfg, 4, 8, 9)
    with torch.no_grad():
        ref.forward(sd, cfg, m, seq, mode="calibrate")
    return sd


def test_the_configuration_names_the_dense_reference():
    from benchmark import reference
    c = json.loads(CONFIG.read_text())
    assert reference.of(cfg_of()) is dense()
    assert c["reference"] == "dense" and c["reduced"] == []
    assert c["model"]["denseblock"] and not c["model"]["resblock"]
    assert c["precision"]["p2p_stacks"] == "float32"


@pytest.mark.parametrize("size", sorted(SIZES))
def test_layout_is_the_systems(size):
    cfg = cfg_of(**SIZES[size])
    want = [(k, tuple(v.shape)) for k, v in system(cfg).state_dict().items()]
    got = [(k, tuple(s)) for k, s, _, _ in dense().spec(cfg)]
    assert got == want


def test_the_ensembles_layout_is_the_systems():
    cfg = cfg_of(multi_scale=True, **SIZES["tiny"])
    want = {k: tuple(v.shape) for k, v in system(cfg).state_dict().items()}
    assert {k: tuple(s) for k, s, _, _ in dense().spec(cfg)} == want


def test_the_dense_schedule():
    """layer_channels at the published widths: layer 1 takes 1 pitch and
    13 pitch-class channels and gives 26 and 51 (the heads' input), and
    its stacks' bottlenecks are 28 (Pitch2Pitch) and 76 (pitch-class)."""
    ref = dense()
    assert ref.layer_channels(1, 4) == (1, 13, 26, 51)
    assert ref.layer_channels(2, 4) == (26, 51, 89, 152)
    assert ref.layer_channels(1, 4, 1) == (1, 5, 10, 19)
    assert (ref.bottleneck(14, 4), ref.bottleneck(39, 4),
            ref.bottleneck(1, 4)) == (28, 76, 4)


@pytest.mark.parametrize("size", sorted(SIZES))
def test_eval_is_the_systems(size):
    cfg = cfg_of(**SIZES[size])
    sd = calibrated(cfg)
    model = system(cfg, sd).eval()
    m, seq = mels(cfg, 2 if size == "published" else 3, 7, 13)
    with torch.no_grad():
        want = model(m[0][..., None], seq)
        got = dense().forward(sd, cfg, m, seq)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-4)
    assert got[0].std(0).max() > 1e-3     # the keys answer to the audio


def test_train_and_calibrate_are_the_systems():
    """mode "train" gives the system's training-mode outputs; "calibrate"
    stores the statistics the system's training-mode BatchNorms take with
    momentum 1 (the batch's mean and biased variance)."""
    cfg = cfg_of(**SIZES["tiny"])
    ref = dense()
    sd = ref.init_weights(cfg, 17, "cpu")
    model = system(cfg, sd).train()
    for bn in model.modules():
        if isinstance(bn, BatchNorm):
            bn.momentum = 1.0
    m, seq = mels(cfg, 3, 6, 19)
    with torch.no_grad():
        want = model(m[0][..., None], seq)
        got = ref.forward(sd, cfg, m, seq, mode="train")
        ref.forward(sd, cfg, m, seq, mode="calibrate")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
    stats = {k: v for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    assert stats and stats.keys() <= sd.keys()
    for k, v in stats.items():
        torch.testing.assert_close(sd[k], v, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("flag", ["resblock", "denseblock", "stack_dtype"])
def test_what_the_reference_refuses(flag):
    """Another block kind, no dense block, a stack below float32."""
    cfg = cfg_of(**SIZES["tiny"])
    cfg = {"resblock": dict(cfg, resblock=True),
           "denseblock": dict(cfg, denseblock=False),
           "stack_dtype": dict(cfg, stack_dtype="bfloat16")}[flag]
    m, seq = mels(cfg, 1, 3, 1)
    with pytest.raises(ValueError):
        ref = dense()
        ref.forward(ref.init_weights(cfg_of(**SIZES["tiny"]), 1, "cpu"),
                    cfg, m, seq)


def test_model_flops_are_the_systems():
    """FlopCounterMode over the reference (on the meta device) and over
    the system's own model, one clip of 901 frames (180 s)."""
    from benchmark.yardstick import densestack, flops
    cfg = cfg_of()
    got = flops.model_flops(cfg, 901)
    model = system(cfg).eval()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(torch.zeros(1, 288, 901, 1), torch.tensor([901]))
    assert got == counter.get_total_flops()
    assert round(got / 1e9, 2) == 24.19
    stacks = densestack.stacks(cfg, B=1, T=901)
    assert [g["name"] for g in stacks] == ["36.0.pc2pc", "36.1.p2p",
                                           "36.1.pc2pc"]
    # the dense stacks' 13.6 GFLOP: Pitch2Pitch 9.33, pitch-class 4.20
    assert [round(densestack.stack_bound(g)["flops"] / 1e9, 2)
            for g in stacks] == [0.1, 9.33, 4.2]
