"""The residual-stack configuration (`pcn_resblock`, `resblock.resident`)
on the CPU: its plain reference (`reference/resblock.py`) against the
system (layout, eval, train and calibrate modes, FLOPs), a tiny run of
its cell, which a reference without the residual add in the system's
place fails, and the readers of the program's `akx.stack` spans on a
synthetic profile."""

import json
import shutil
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import bench_tiny
from benchmark import harness, reference, stand_in
from benchmark.harness import run_cell
from benchmark.reference import cqt as ref_cqt
from benchmark.reference import model as ref_model
from benchmark.reference import resblock as ref_res
from benchmark.traffic import common, synth
from benchmark.yardstick import flops, resstack
from benchmark.yardstick.profile import Profile, Row
from benchmark.yardstick.roofline import F32_FLOPS, HBM_BYTES_PER_S

SR, HOP = 22050, 4410
CELL = "resblock.resident"
TINY = "tiny.resblock.resident"
# (Config fields of a tiny residual model, or the published ones)
SIZES = {"tiny": dict(octaves=4, n_filters=2, conv_layers=2,
                      kernel_size=3, head_layers=1),
         "published": {}}


def cfg_of(**fields) -> dict:
    """The configuration as the reference reads it (Context.model)."""
    m = dict(json.loads((harness.HERE / "configs" / "pcn_resblock.json")
                        .read_text())["model"], **fields)
    return dict(m, reference="resblock", bins_per_octave=36,
                cqt_stream_dtype="bfloat16", stack_dtype="float32")


def system(cfg: dict, sd=None):
    from audio_key_estimation_torch.config import Config
    from audio_key_estimation_torch.models import build_model
    from audio_key_estimation_torch.models.convert import load_state_dict
    fields = {k: v for k, v in cfg.items()
              if k not in ("reference", "bins_per_octave",
                           "cqt_stream_dtype", "stack_dtype")}
    model = build_model(Config(**fields, fused_convstack=True))
    if sd is not None:
        load_state_dict(model, sd)
    return model


def mels(cfg, n, seconds, seed):
    lengths = [seconds * SR - 101 * i for i in range(n)]
    y = synth.pcm16_batch(lengths, seconds * SR, SR, seed, "cpu")
    seq = torch.tensor([1 + k // HOP for k in lengths])
    return [ref_cqt.cqt(y, sr=SR, hop=HOP, bins_per_octave=36,
                        octaves=cfg["octaves"])], seq


def calibrated(cfg):
    sd = ref_res.init_weights(cfg, 11, "cpu")
    m, seq = mels(cfg, 4, 8, 9)
    with torch.no_grad():
        ref_res.forward(sd, cfg, m, seq, mode="calibrate")
    return sd


def test_the_configuration_names_the_residual_reference(repo):
    ctx = harness.context(repo, CELL, 1, "cpu")
    assert reference.of(ctx.model) is ref_res
    assert ctx.model["resblock"] and ctx.model["stack_dtype"] == "float32"
    assert ctx.config["reduced"] == []


@pytest.mark.parametrize("size", sorted(SIZES))
def test_layout_is_the_systems(size):
    cfg = cfg_of(**SIZES[size])
    want = [(k, tuple(v.shape)) for k, v in system(cfg).state_dict().items()]
    got = [(k, tuple(s)) for k, s, _, _ in ref_res.spec(cfg)]
    assert got == want


def test_the_ensembles_layout_is_the_systems():
    cfg = cfg_of(multi_scale=True, **SIZES["tiny"])
    want = {k: tuple(v.shape) for k, v in system(cfg).state_dict().items()}
    assert {k: tuple(s) for k, s, _, _ in ref_res.spec(cfg)} == want


@pytest.mark.parametrize("size", sorted(SIZES))
def test_eval_is_the_systems(size):
    """The repo's float32 logit bars: key rtol 1e-4 / atol 1e-5, tonic
    1e-4."""
    cfg = cfg_of(**SIZES[size])
    sd = calibrated(cfg)
    model = system(cfg, sd).eval()
    m, seq = mels(cfg, 2 if size == "published" else 3, 7, 13)
    with torch.no_grad():
        want = model(m[0][..., None], seq)
        got = ref_res.forward(sd, cfg, m, seq)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-4)
    assert got[0].std(0).max() > 1e-3     # the keys answer to the audio


def test_train_and_calibrate_are_the_systems():
    """mode "train" gives the system's training-mode outputs; "calibrate"
    stores the statistics the system's training-mode BatchNorms take with
    momentum 1 (the batch's mean and biased variance)."""
    from audio_key_estimation_torch.models.blocks import BatchNorm
    cfg = cfg_of(**SIZES["tiny"])
    sd = ref_res.init_weights(cfg, 17, "cpu")
    model = system(cfg, sd).train()
    for bn in model.modules():
        if isinstance(bn, BatchNorm):
            bn.momentum = 1.0
    m, seq = mels(cfg, 3, 6, 19)
    with torch.no_grad():
        want = model(m[0][..., None], seq)
        got = ref_res.forward(sd, cfg, m, seq, mode="train")
        ref_res.forward(sd, cfg, m, seq, mode="calibrate")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
    stats = {k: v for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    assert stats and stats.keys() <= sd.keys()
    for k, v in stats.items():
        torch.testing.assert_close(sd[k], v, rtol=1e-4, atol=1e-6)


def test_a_bf16_stack_is_refused():
    cfg = dict(cfg_of(**SIZES["tiny"]), stack_dtype="bfloat16")
    m, seq = mels(cfg, 1, 3, 1)
    with pytest.raises(ValueError, match="float32"):
        ref_res.forward(ref_res.init_weights(cfg, 1, "cpu"), cfg, m, seq)


def test_model_flops_are_the_systems():
    """FlopCounterMode over the reference (on the meta device) and over
    the system's own model, one clip of 901 frames (180 s)."""
    cfg = cfg_of()
    got = flops.model_flops(cfg, 901)
    model = system(cfg).eval()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(torch.zeros(1, 288, 901, 1), torch.tensor([901]))
    assert got == counter.get_total_flops()
    assert round(got / 1e9, 2) == 27.91
    stacks = resstack.stacks(cfg, B=1, T=901)
    assert [g["name"] for g in stacks] == ["36.0.pc2pc", "36.1.p2p",
                                           "36.1.pc2pc"]
    assert sum(resstack.stack_bound(g)["flops"] for g in stacks) / got \
        == pytest.approx(26.84 / 27.91, abs=1e-3)


def test_a_residual_stacks_bound_by_hand():
    """B 1, H 2, T 3, one block of 1 channel, 1x1 convs: stem 1 -> 1 (12
    operations; 6 + 6 floats moved, 2 weights), conv1 1 -> 2 (24; 6 +
    12, 4), conv2 2 -> 1 with the skip (24; 12 + 6 + 6, 3)."""
    g = {"B": 1, "H": 2, "T": 3, "kh": 1, "kw": 1, "cin": 1, "f": 1,
         "blocks": 1}
    b = resstack.stack_bound(g)
    assert (b["flops"], b["bytes"], b["convs"]) == (60, 4 * 63, 3)
    assert resstack.convs(g) == 3
    assert b["bound_s"] == pytest.approx(4 * 63 / HBM_BYTES_PER_S)
    big = dict(g, B=256, H=288, T=901, kh=7, kw=7, cin=5, f=8, blocks=3)
    want = 2 * 256 * 288 * 901 * 49 * (8 * 5 + 3 * 2 * 16 * 8)
    assert resstack.stack_bound(big)["flops"] == want
    assert resstack.stack_bound(big)["bound_s"] == pytest.approx(
        want / F32_FLOPS, rel=1e-12)
    assert resstack.stacks(dict(cfg_of(), resblock=False), B=1, T=9) == []


# ---------------------------------------------------------------------------
# the cell, tiny, on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture
def tiny(checkout):
    """The cell on bench_tiny's resident mix, under its own limits and
    metrics."""
    home = checkout / "benchmark"
    bench_tiny.add_tiny_cells(checkout)
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": TINY, "config": "pcn_resblock",
                               "traffic": "tiny_resident", "chips": 1,
                               "why": "t"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(TINY)
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copy(home / "limits" / f"{CELL}.json",
                home / "limits" / f"{TINY}.json")
    return checkout


class NoSkip(ref_res.Net):
    """The residual reference without its residual add."""

    def stack(self, x, key, equivariant):
        h = ref_model.leaky(self.bn(self.conv(x, f"{key}.layer.0",
                                              equivariant), f"{key}.layer.1"))
        for j in range(self.cfg["conv_layers"]):
            b = f"{key}.layer.{3 + j}"
            r = ref_model.leaky(self.bn(self.conv(h, b + ".conv1",
                                                  equivariant), b + ".b1"))
            h = ref_model.leaky(self.bn(self.conv(r, b + ".conv2",
                                                  equivariant), b + ".b2"))
        return h


class Stand(stand_in.Estimator):
    """The reference in the system's place, its stacks `net`'s."""

    net = ref_res.Net

    def model(self, *args):
        *feats, seq = args
        return self.net(self.sd, self.m, "", False)(feats[0][..., 0], seq)


@pytest.mark.parametrize("net,correct", [(ref_res.Net, True),
                                         (NoSkip, False)])
def test_a_reference_without_the_residual_add_is_not_correct(
        tiny, monkeypatch, net, correct):
    monkeypatch.setattr(Stand, "net", net)
    monkeypatch.setattr(common, "estimator",
                        lambda ctx, sd: Stand(ctx, sd, "tf32"))
    res = run_cell(tiny, TINY, 2**31 + 23, 0.3, False, "cpu")
    assert res["correct"] is correct, res["checks"]


def test_a_tiny_traced_run_is_correct(tiny):
    """The system itself, traced: correct, with the whole call's MFU (the
    CPU has no device rows for the readers of device time)."""
    res = run_cell(tiny, TINY, 2**31 + 29, 0.3, True, "cpu")
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["correct"], res["checks"]
    assert "mfu.resident" in res["metrics"]
    assert not {"stack_ms_per_audio_min", "res_stack_roofline"} \
        & set(res["metrics"])


# ---------------------------------------------------------------------------
# the readers of akx.stack, on a synthetic profile
# ---------------------------------------------------------------------------

OFFSET_US = 500.0      # the profiler's clock less the program's, in us


def span(i, name, start_us, end_us, parent=None, **counts):
    """A program span whose times are given on the profiler's clock."""
    from audio_key_estimation_torch.utils.profiling import Span
    return Span(i, name, int((start_us - OFFSET_US) * 1e3),
                int((end_us - OFFSET_US) * 1e3), parent, None, counts)


def synthetic(counts=((7, 3),) * 3):
    """Two calls of three residual stacks each: (profile, spans). Each
    call's akx.model span opens 10 us after its bench.model range; the
    first call's last launch comes 5 us before its span closes, the
    second's 8 us."""
    rows, ranges, found = [], [], []
    for c, (at, tail) in enumerate(((1000.0, 5.0), (11000.0, 8.0))):
        ranges.append(("bench.model", at, at + 4000.0))
        found.append(span(10 * c, "akx.model", at + 10.0, at + 3990.0))
        for k, (lo, hi) in enumerate(((100, 900), (1500, 2900),
                                      (3100, 3800))):
            convs, blocks = counts[k]
            found.append(span(10 * c + 1 + k, "akx.stack", at + lo, at + hi,
                              10 * c, convs=convs, res_blocks=blocks))
            # inside: at its start, in it, 6 us before it closes
            for t, dur in ((lo + 1, 10.0), ((lo + hi) / 2, 100.0),
                           (hi - 6, 40.0)):
                rows.append(Row("conv", 9e4 + at + t, 9e4 + at + t + dur,
                                at + t))
            # outside: 20 us before it opens
            rows.append(Row("cat", 9e4 + at + lo - 20, 9e4 + at + lo,
                            at + lo - 20))
        rows.append(Row("sigmoid", 9e4 + at + 3990, 9e4 + at + 3991,
                        at + 3990.0 - tail))
    return Profile(sorted(rows, key=lambda r: r.start_us), sorted(ranges),
                   1.0), found


def readings(profile, model=None):
    model = model or cfg_of()
    return SimpleNamespace(
        profile=profile, call_minutes=2.0, model=model,
        geometry={"cqts": [{"B": 4, "L": 9 * HOP - 1, "hop": HOP}]})


def readers(repo):
    ctx = harness.context(repo, CELL, 1, "cpu")
    return (harness.reader(ctx, "stack_ms_per_audio_min"),
            harness.reader(ctx, "res_stack_roofline"))


def test_the_readers_place_the_spans_on_the_profilers_clock(repo,
                                                            monkeypatch):
    from audio_key_estimation_torch.utils import profiling
    from benchmark.yardstick import program_clock
    profile, found = synthetic()
    monkeypatch.setattr(profiling, "spans", lambda: found)
    # the first call's last launch, 5 us before its span closed, bounds
    # the offset tighter than any range's open (10 us) or the second
    # call's launch (8 us)
    assert program_clock.offset(profile, found) == pytest.approx(
        OFFSET_US - 5.0)
    placed = program_clock.placed(profile, found, "akx.stack")
    # 5 us early: each launch inside a stack is its, the cats launched
    # 20 us before one opens are not
    assert [len(rows) for _, rows in placed] == [3] * 6
    assert all(r.name == "conv" for _, rows in placed for r in rows)
    stack_ms, roofline = readers(repo)
    r = readings(profile)
    assert stack_ms.read(r) == pytest.approx(6 * 150.0 / 1e3 / 2.0)
    shapes = resstack.stacks(r.model, B=4, T=9)
    want = 2 * sum(resstack.stack_bound(g)["bound_s"] for g in shapes)
    assert roofline.read(r) == pytest.approx(100.0 * want / (6 * 150e-6))


def test_the_readers_give_nothing_without_stack_spans(repo, monkeypatch):
    """The parent's program records akx.model but no akx.stack; the
    reference in the system's place records neither."""
    from audio_key_estimation_torch.utils import profiling
    profile, found = synthetic()
    for kept in ([s for s in found if s.name == "akx.model"], []):
        monkeypatch.setattr(profiling, "spans", lambda: kept)
        for mod in readers(repo):
            assert mod.read(readings(profile)) is None


@pytest.mark.parametrize("case", ["convs", "plain", "missing"])
def test_the_roofline_gives_nothing_where_the_counts_disagree(
        repo, monkeypatch, case):
    """A residual span whose convs are not the bound's, spans without
    residual blocks, and a call that lacks one of its residual spans."""
    from audio_key_estimation_torch.utils import profiling
    counts = {"convs": ((7, 3), (5, 3), (7, 3)), "plain": ((3, 0),) * 3,
              "missing": ((7, 3),) * 3}[case]
    profile, found = synthetic(counts)
    if case == "missing":
        found = [s for s in found if s.id != 3]
    monkeypatch.setattr(profiling, "spans", lambda: found)
    stack_ms, roofline = readers(repo)
    assert roofline.read(readings(profile)) is None
    assert stack_ms.read(readings(profile)) is not None
