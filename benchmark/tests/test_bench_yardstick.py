"""The frozen yardstick gives its sources' numbers: the port's chip
checks (`chip_smoke.py`) and the port bench's FLOP count, at the shapes
the port's batch phase measured (B = 64, 256, 1024 at the 180 s bucket,
256 at 60 s, 64 and 256 at 420 s; 22050 Hz, hop 4410, int16 in, bf16
streams), and the MFU's FLOP count of a clip equals FlopCounterMode
over the reference run on that clip alone."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import model as ref_model
from benchmark.yardstick import flops, profile, roofline

SR, HOP = 22050, 4410
SHAPES = [(64, 180), (256, 180), (1024, 180), (256, 60), (64, 420),
          (256, 420)]


@pytest.fixture(scope="module")
def smoke():
    return pytest.importorskip("chip_smoke")


def test_peaks_and_scalars(smoke):
    assert (roofline.HBM_BYTES_PER_S, roofline.F32_FLOPS,
            roofline.TF32_FLOPS, roofline.BF16_FLOPS) == (
        smoke.HBM_BYTES_PER_S, smoke.F32_FLOPS, smoke.TF32_FLOPS,
        smoke.BF16_FLOPS)
    assert profile.PAD_LAUNCHES == smoke.PAD_LAUNCHES
    for bf16, dt in ((True, torch.bfloat16), (False, torch.float32)):
        assert roofline.tf32_products(bf16) == smoke.tf32_products(dt)
    for nb, fl in ((1e9, 0.0), (1e6, 1e12), (2e9, 3e12)):
        b = smoke.bound(nb, fl)
        assert roofline.bound(nb, fl) == {"bound_s": b["bound_ms"] / 1e3,
                                          "bound_by": b["bound_by"]}


@pytest.mark.parametrize("bpo", [36, 12])
@pytest.mark.parametrize("B,seconds", SHAPES)
def test_cqt_bounds(smoke, B, seconds, bpo):
    from audio_key_estimation_torch.ops import cqt as C
    from audio_key_estimation_torch.ops import cqt_cuda as K
    p = C.CQTParams(sr=SR, hop=HOP, bins_per_octave=bpo, octaves=8)
    L = seconds * SR
    n_fft = C.kernel_bank(p)["n_fft"]
    assert roofline.n_fft(SR, bpo, 8) == n_fft
    lay = K.arena_layout(L, 8, n_fft)
    T = 1 + L // HOP
    starts = torch.tensor([C._frame_starts(HOP, o, T) for o in range(8)])
    y = torch.empty((B, L), dtype=torch.int16, device="meta")
    a, b = smoke.cqt_bounds(y, p, lay, torch.bfloat16, starts)
    ra, rb = roofline.cqt_bounds(B, L, sr=SR, hop=HOP, bins_per_octave=bpo,
                                 octaves=8, input_itemsize=2,
                                 stream_itemsize=2)
    for got, want in ((ra, a), (rb, b)):
        assert got["bound_by"] == want["bound_by"]
        assert got["bound_s"] * 1e3 == pytest.approx(want["bound_ms"],
                                                     rel=1e-12)
    for o in range(8):
        assert roofline.window_cover(roofline.frame_starts(HOP, o, T),
                                     n_fft) == smoke.window_cover(
            starts[o].tolist(), n_fft)


@pytest.mark.parametrize("B,seconds", SHAPES)
def test_stack_bytes(smoke, B, seconds):
    T = 1 + seconds * SR // HOP
    for H in (288, 96):
        assert roofline.stack_bytes(B, H, T, 5, 3) == smoke.stack_bytes(
            B, H, T, 5, 3)
        assert roofline.layer_bytes(B, H, T, 5, 3) == smoke.layer_bytes(
            B, H, T, 5, 3)
        assert sum(roofline.layer_bytes(B, H, T, 5, 3)) == \
            roofline.stack_bytes(B, H, T, 5, 3)


@pytest.mark.parametrize("bpo", [36, 12])
@pytest.mark.parametrize("seconds", [60, 120, 180, 420])
def test_frontend_flops(bpo, seconds):
    from audio_key_estimation_torch import bench
    from audio_key_estimation_torch.ops.cqt import CQTParams
    L = seconds * SR + 17
    p = CQTParams(sr=SR, hop=HOP, bins_per_octave=bpo, octaves=8)
    assert flops.frontend_flops(sr=SR, hop=HOP, bins_per_octave=bpo,
                                octaves=8, L=L, batch=3) == \
        bench.frontend_flops(p, L, 3)


def config(name: str) -> dict:
    from benchmark.harness import HERE
    c = json.loads((HERE / "configs" / f"{name}.json").read_text())
    m = dict(c["model"])
    m.update(bins_per_octave=36, cqt_stream_dtype="bfloat16",
             stack_dtype="bfloat16", reference=c["reference"])
    return m


@pytest.mark.parametrize("name", ["pcn_default", "pcn_multi_scale"])
@pytest.mark.parametrize("frames", [31, 40, 57])
def test_model_flops_equal_a_real_run_on_the_clip_alone(name, frames):
    cfg = config(name)
    sd = ref_model.init_weights(cfg, 3, "cpu")
    mels = [torch.rand(1, 8 * b, frames) for b in
            ((36, 12) if cfg["multi_scale"] else (36,))]
    counter = FlopCounterMode(display=False)
    with counter:
        ref_model.forward(sd, cfg, mels, torch.tensor([frames]))
    assert counter.get_total_flops() > 0
    assert flops.model_flops(cfg, frames) == counter.get_total_flops()


def test_model_flops_grow_with_the_clip():
    cfg = config("pcn_default")
    assert flops.model_flops(cfg, 901) > flops.model_flops(cfg, 751) > 0
