"""PyTorch port on the card: the pitch-class stacks' conv kernel
(csrc/pcconv.cu) against a float64 version.

 * each conv of `pcstack_cuda.CONVS` at the resident cells' shape (256,
   cin, 12, 901) and at ragged T (1, 2, 5, 130), against its plain version
   computed in float64: the kernel passes a bar that the same conv on
   TF32-rounded operands (10 mantissa bits, as a tensor core reads
   float32) fails;
 * each whole stack the benchmark's configurations serve (plain 1 -> 4
   and 12 -> 16 stacks of three convs; residual stacks of a stem and three
   blocks) at those shapes, against the module path in float64, one
   launch a conv;
 * a forward of the default, the resblock and the multi-scale model
   launches it 6, 14 and 12 times, and a training-mode forward never.

Marked `card`; here without CUDA each skips. This file imports nothing of
JAX, so on the card it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_pcstack_card.py
"""

import pytest
import torch

from audio_key_estimation_torch.config import Config
from audio_key_estimation_torch.models import build_model
from audio_key_estimation_torch.models.blocks import ConvStack
from audio_key_estimation_torch.ops import pcstack_cuda as PS
from audio_key_estimation_torch.ops import stack_kernels as SK

pytestmark = pytest.mark.card

# float32 sums of 84 to 2688 products against float64, outputs of order 1
MAX_ABS = 1e-4
MEAN_ABS = 1e-6
# a stack's output against the float64 module path, as shares of its
# largest and mean magnitude
STACK_MAX_REL, STACK_MEAN_REL = 1e-4, 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs the card (CUDA is not available here)")
    return torch.device("cuda")


def operands(cin, cout, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    bound = 1.0 / (cin * 84) ** 0.5
    w = (torch.rand(cin, 7, 12, cout, generator=g) * 2 - 1) * bound
    b = (torch.rand(cout, generator=g) * 2 - 1) * bound
    s = 1 + 0.2 * torch.randn(cout, generator=g)
    t = 0.1 * torch.randn(cout, generator=g)
    return PS.Conv(*(v.to(device) for v in (w, b, s, t)))


def tf32(t: torch.Tensor) -> torch.Tensor:
    """t rounded to TF32's 10 mantissa bits (to nearest), as float64."""
    i = t.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32).double()


def errors(got, want):
    d = (got.double() - want).abs()
    return float(d.max()), float(d.mean())


def passes(err):
    return err[0] <= MAX_ABS and err[1] <= MEAN_ABS


@pytest.mark.parametrize("geometry", [(256, 901), (2, 1), (3, 2), (2, 5),
                                      (5, 130)], ids=str)
@pytest.mark.parametrize("conv", PS.CONVS, ids=str)
def test_kernel_against_float64(card, conv, geometry):
    cin, cout, skip = conv
    B, T = geometry
    g = torch.Generator(device=card).manual_seed(B * cin + T)
    x = torch.randn(B, cin, 12, T, device=card, generator=g)
    s = torch.randn(B, cout, 12, T, device=card, generator=g) if skip \
        else None
    c = operands(cin, cout, card)
    before = PS.pcconv.launches
    got = PS.pcconv(x, c, s)
    assert PS.pcconv.launches == before + 1
    assert got.shape == (B, cout, 12, T) and bool(torch.isfinite(got).all())
    s64 = None if s is None else s.double()
    want = PS.pcconv_plain(x.double(), PS.Conv(*(v.double() for v in c)),
                           s64)
    err = errors(got, want)
    assert passes(err), err
    if geometry == (256, 901):
        rounded = PS.Conv(tf32(c.weight), *(v.double() for v in c[1:]))
        tf = PS.pcconv_plain(tf32(x), rounded, s64)
        assert not passes(errors(tf, want)), errors(tf, want)


def seeded_stack(cin, f, resblock, device, seed=0) -> ConvStack:
    """A pitch-class stack at the published widths, eval mode, BatchNorm
    statistics and affines drawn from the seed."""
    g = torch.Generator().manual_seed(seed)
    stack = ConvStack(cin, f, 7, 3, True, g, fused_serving=True,
                      resblock=resblock).eval()
    with torch.no_grad():
        for m in stack.modules():
            if hasattr(m, "running_var"):
                n = m.running_var.numel()
                m.weight.copy_(1 + 0.2 * torch.randn(n, generator=g))
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                m.running_var.copy_(0.5 + torch.rand(n, generator=g))
    return stack.to(device)


@pytest.mark.parametrize("T", [901, 5], ids=str)
@pytest.mark.parametrize("stack", [(1, 4, False), (12, 16, False),
                                   (1, 4, True), (12, 16, True)], ids=str)
def test_a_stack_against_float64(card, stack, T):
    cin, f, resblock = stack
    m = seeded_stack(cin, f, resblock, card)
    x = torch.randn(256 if T == 901 else 3, cin, 12, T, device=card,
                    generator=torch.Generator(device=card).manual_seed(T))
    assert m.kernel is SK.PCCONV and m.runs_kernel(x)
    n = PS.pcconv.launches
    with torch.inference_mode():
        got = m(x)
    assert PS.pcconv.launches == n + m.span_counts["convs"] \
        == n + (7 if resblock else 3)
    with torch.inference_mode():
        ref = m.double()(x.double())
    d = (got.double() - ref).abs()
    rel = float(d.max() / ref.abs().max())
    mean_rel = float(d.mean() / ref.abs().mean())
    assert rel <= STACK_MAX_REL and mean_rel <= STACK_MEAN_REL, (
        rel, mean_rel)


@pytest.mark.parametrize("kw,want", [({}, 6), ({"resblock": True}, 14),
                                     ({"multi_scale": True}, 12)], ids=str)
def test_a_model_forward_launches_one_a_conv(card, kw, want):
    cfg = Config(fused_convstack=True, **kw)
    model = build_model(cfg).eval().to(card)
    T = 200
    mels = [torch.randn(2, cfg.pitches, T, 1, device=card)]
    if cfg.multi_scale:
        mels.append(torch.randn(2, cfg.octaves * 12, T, 1, device=card))
    seq = torch.tensor([T, 150], dtype=torch.int32, device=card)
    n = PS.pcconv.launches
    with torch.inference_mode():
        model(*mels, seq)
    assert PS.pcconv.launches == n + want
    model.train()
    with torch.no_grad():
        model(*mels, seq)
    assert PS.pcconv.launches == n + want
