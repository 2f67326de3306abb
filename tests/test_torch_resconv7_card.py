"""PyTorch port on the card: the residual Pitch2Pitch conv kernel
(csrc/resconv7.cu) against its plain version.

 * each of its three convs (stem 5 -> 8, a block's 8 -> 16 and 16 -> 8
   with the skip) at the resblock.resident cell's shape (256, cin, 288,
   901) and at edge geometries (T 3, 4, 129; H 3, 13), against the plain
   version in IEEE float32 (cuDNN, TF32 off): the two sum in other orders,
   so they agree to float32 rounding and not bit for bit;
 * a residual stack's forward launches it 7 times and kernel C never, and
   a resblock PitchClassNet's forward launches it 7 times (its one
   Pitch2Pitch stack) with kernel C's count still 0.

Marked `card`; here without CUDA each skips. This file imports nothing of
JAX, so on the card it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_resconv7_card.py
"""

import pytest
import torch

from audio_key_estimation_torch.config import Config
from audio_key_estimation_torch.models import PitchClassNet
from audio_key_estimation_torch.models.blocks import ConvStack
from audio_key_estimation_torch.ops import convstack_cuda as CS
from audio_key_estimation_torch.ops import resstack_cuda as RS
from audio_key_estimation_torch.ops import stack_kernels as SK
from audio_key_estimation_torch.utils.precision import ieee_float32

pytestmark = pytest.mark.card

# float32 sums of 245 to 784 products in two orders, outputs of order 1
MAX_ABS = 1e-4
MEAN_ABS = 1e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs the card (CUDA is not available here)")
    return torch.device("cuda")


def operands(cin, cout, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    bound = 1.0 / (cin * 49) ** 0.5
    w = (torch.rand(cin, 7, 7, cout, generator=g) * 2 - 1) * bound
    b = (torch.rand(cout, generator=g) * 2 - 1) * bound
    s = 1 + 0.2 * torch.randn(cout, generator=g)
    t = 0.1 * torch.randn(cout, generator=g)
    return RS.Conv(*(v.to(device) for v in (w, b, s, t)))


def check(got, want):
    d = (got - want).abs()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert float(d.max()) <= MAX_ABS and float(d.mean()) <= MEAN_ABS, (
        float(d.max()), float(d.mean()))


@pytest.mark.parametrize("geometry", [(256, 288, 901), (2, 288, 3),
                                      (2, 288, 4), (3, 288, 129),
                                      (2, 3, 901), (2, 13, 901), (5, 13, 3)],
                         ids=str)
@pytest.mark.parametrize("conv", RS.CONVS, ids=str)
def test_kernel_against_plain(card, conv, geometry):
    cin, cout, skip = conv
    B, H, T = geometry
    g = torch.Generator(device=card).manual_seed(B * H + T)
    x = torch.randn(B, cin, H, T, device=card, generator=g)
    s = torch.randn(B, cout, H, T, device=card, generator=g) if skip \
        else None
    c = operands(cin, cout, card)
    before = RS.resconv7.launches
    got = RS.resconv7(x, c, s)
    assert RS.resconv7.launches == before + 1
    with ieee_float32():
        want = RS.resconv7_plain(x, c, s)
    torch.cuda.synchronize()
    check(got, want)


def test_a_stack_is_seven_launches_and_no_kernel_c(card):
    stack = ConvStack(5, 8, 7, 3, False, torch.Generator().manual_seed(1),
                      fused_serving=True, resblock=True).eval().to(card)
    x = torch.randn(4, 5, 288, 901, device=card)
    assert stack.kernel is SK.RESCONV7 and stack.runs_kernel(x)
    n, c = RS.resconv7.launches, CS.conv7_layer.launches
    with torch.inference_mode():
        got = stack(x)
        with ieee_float32():
            want = RS.residual_stack_plain(
                x, stack.kernel.operands(stack.conv_pairs()))
    assert RS.resconv7.launches == n + 7
    assert CS.conv7_layer.launches == c
    check(got, want)


def test_a_resblock_model_launches_it_and_not_kernel_c(card):
    cfg = Config(resblock=True, fused_convstack=True)
    model = PitchClassNet(cfg).eval().to(card)
    mel = torch.randn(2, cfg.pitches, 200, 1, device=card)
    seq = torch.tensor([200, 150], dtype=torch.int32, device=card)
    n, c = RS.resconv7.launches, CS.conv7_layer.launches
    with torch.inference_mode(), ieee_float32():
        model(mel, seq)
    assert RS.resconv7.launches == n + 7
    assert CS.conv7_layer.launches == c
