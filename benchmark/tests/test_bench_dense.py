"""The dense-stack configuration (`pcn_denseblock`, `denseblock.resident`)
and the library files cell (`default.files.library`) on the CPU: tiny
runs of both cells, which a dense reference without its dense
connections or with circular pads in the system's place fails; the
dense stacks' bound (`yardstick/densestack.py`) by hand; and its two
readers, `dense_stack_roofline` and `dense_cat_share`, on a synthetic
profile. The reference itself is held against the system in
`tests/test_torch_dense_reference.py`."""

import json
import shutil
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

import bench_tiny
from benchmark import harness, stand_in
from benchmark.harness import run_cell
from benchmark.reference import dense as ref_dense
from benchmark.reference import model as ref_model
from benchmark.traffic import common
from benchmark.yardstick import densestack
from benchmark.yardstick.profile import Profile, Row
from benchmark.yardstick.roofline import F32_FLOPS, HBM_BYTES_PER_S

HOP = 4410
CELL = "denseblock.resident"
LIBRARY = "default.files.library"
TINY = {   # tiny cell: (configuration, mix, the real cell it stands for)
    "tiny.denseblock.resident": ("pcn_denseblock", "tiny_resident", CELL),
    "tiny.default.files.library": ("pcn_default", "tiny_library", LIBRARY),
}
# the library mix's shape at a CPU's size: one request serves the corpus
TINY_LIBRARY = {"kind": "files", "sr": 22050, "corpus": 4, "album": 4,
                "seconds_min": 40, "seconds_max": 70, "sample_every": 2}


@pytest.fixture
def tiny(checkout):
    """Both cells on bench_tiny's mixes, under their own limits and
    metrics."""
    home = checkout / "benchmark"
    bench_tiny.add_tiny_cells(checkout)
    (home / "mixes" / "tiny_library.json").write_text(
        json.dumps(TINY_LIBRARY))
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    for cell, (config, mix, real) in TINY.items():
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": mix, "chips": 1, "why": "t"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(cell)
        shutil.copy(home / "limits" / f"{real}.json",
                    home / "limits" / f"{cell}.json")
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))
    return checkout


def test_the_cells_name_their_configuration_and_mix(repo):
    ctx = harness.context(repo, CELL, 1, "cpu")
    assert ctx.model["denseblock"] and ctx.model["stack_dtype"] == "float32"
    assert ctx.config["reduced"] == [] and ctx.mix["batch"] == 256
    ctx = harness.context(repo, LIBRARY, 1, "cpu")
    assert ctx.config["name"] == "pcn_default"
    mix = ctx.mix
    # each request's int16 batch, padded to the 420 s bucket, is over the
    # system's 1 GiB staging buffer
    assert mix["album"] * 420 * mix["sr"] * 2 > 1 << 30
    assert mix["corpus"] == 2 * mix["album"]


class NoInput(ref_dense.Net):
    """The dense reference whose concatenations after the first layer's
    input hold zeros in the block input's place."""

    def stack(self, x, key, equivariant):
        features = [x]
        for i in range(self.cfg["conv_layers"]):
            d = f"{key}.layer.0.denselayer{i + 1}"
            h = torch.cat(features, dim=1)
            y = self.conv(ref_model.leaky(self.bn(h, d + ".norm1")),
                          d + ".conv1", equivariant)
            y = self.conv(F.relu(self.bn(y, d + ".norm2")), d + ".conv2",
                          equivariant)
            features = [torch.zeros_like(x)] + features[1:] + [y]
        return torch.cat(features, dim=1)


class Circular(ref_dense.Net):
    """The dense reference with its Pitch2Pitch convs padded circularly."""

    def conv(self, x, key, equivariant):
        if equivariant:
            return super().conv(x, key, equivariant)
        w = self.w(key + ".weight")
        return F.conv2d(ref_model.circular_pad(x, w.shape[2] // 2,
                                               w.shape[3] // 2), w)


class Stand(stand_in.Estimator):
    """The reference in the system's place, its stacks `net`'s."""

    net = ref_dense.Net

    def model(self, *args):
        *feats, seq = args
        return self.net(self.sd, self.m, "", False)(feats[0][..., 0], seq)


@pytest.mark.parametrize("net,correct", [(ref_dense.Net, True),
                                         (NoInput, False),
                                         (Circular, False)])
def test_a_faulty_dense_reference_is_not_correct(tiny, monkeypatch, net,
                                                 correct):
    monkeypatch.setattr(Stand, "net", net)
    monkeypatch.setattr(common, "estimator",
                        lambda ctx, sd: Stand(ctx, sd, "tf32"))
    res = run_cell(tiny, "tiny.denseblock.resident", 2**31 + 31, 0.3, False,
                   "cpu")
    assert res["correct"] is correct, res["checks"]


def test_a_tiny_dense_run_is_correct(tiny):
    """The system itself, traced: correct, with the whole call's MFU (the
    CPU has no device rows for the readers of device time)."""
    res = run_cell(tiny, "tiny.denseblock.resident", 2**31 + 37, 0.3, True,
                   "cpu")
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["correct"], res["checks"]
    assert "mfu.resident" in res["metrics"]
    assert not {"dense_stack_roofline", "dense_cat_share"} & set(
        res["metrics"])


def test_a_tiny_library_run_is_correct(tiny):
    """The library cell's path at a CPU's size, traced: every request
    answered and correct, none of its bytes through the page-locked
    buffer (off CUDA, as over the staging cap on the card)."""
    res = run_cell(tiny, "tiny.default.files.library", 2**31 + 41, 0.3,
                   True, "cpu")
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["correct"], res["checks"]
    assert res["metrics"]["pinned_h2d_share.files"]["value"] == 0.0
    assert "useful_sample_share.files" in res["metrics"]


# ---------------------------------------------------------------------------
# the bound, by hand
# ---------------------------------------------------------------------------

def test_a_dense_stacks_bound_by_hand():
    """B 1, H 2, T 3, one layer on 1 channel, growth 1, bottleneck 1,
    kernel 1: two 1 -> 1 convs, 12 operations each; 6 + 6 floats moved
    and 1 weight; the concatenations write the input (1 channel) and the
    output (2), 3 x 6 floats. A pitch-class stack of the same: 12 rows,
    12 x 1 kernels, a bias each."""
    g = {"B": 1, "H": 2, "T": 3, "kw": 1, "cin": 1, "growth": 1, "mid": 1,
         "layers": 1, "equivariant": False}
    b = densestack.stack_bound(g)
    assert (b["flops"], b["bytes"], b["convs"]) == (24, 2 * 4 * 13, 2)
    assert b["bound_s"] == pytest.approx(2 * 4 * 13 / HBM_BYTES_PER_S)
    assert densestack.cat_bytes(g) == 4 * 3 * 6
    pc = dict(g, H=12, equivariant=True)
    b = densestack.stack_bound(pc)
    # each conv: 2 x 36 positions x 12 taps; 36 + 36 floats, 12 weights
    # and a bias
    assert (b["flops"], b["bytes"]) == (2 * 864, 2 * 4 * 85)
    assert densestack.cat_rows(pc) == 1 + 2 and densestack.cat_rows(g) == 1


def test_the_published_stacks_bound():
    """The three stacks at 256 clips of 901 frames. In the Pitch2Pitch
    stack (14 -> 26 channels, bottleneck 28) the 7 x 7 convs are bound by
    their operations, the bottlenecks by their bytes."""
    cfg = dict(json.loads((harness.HERE / "configs" / "pcn_denseblock.json")
                          .read_text())["model"], reference="dense",
               bins_per_octave=36)
    shapes = densestack.stacks(cfg, B=256, T=901)
    assert [(g["name"], g["H"], g["T"], g["cin"], g["mid"])
            for g in shapes] == [("36.0.pc2pc", 12, 901, 1, 4),
                                 ("36.1.p2p", 288, 901, 14, 28),
                                 ("36.1.pc2pc", 12, 901, 39, 76)]
    p2p = densestack.stack_bound(shapes[1])
    n = 256 * 288 * 901
    wide = 2 * n * 28 * 4 * 49
    assert p2p["flops"] == sum(2 * n * ci * 28 + wide for ci in (14, 18, 22))
    assert p2p["bound_s"] == pytest.approx(sum(
        4 * (n * (ci + 28) + 28 * ci) / HBM_BYTES_PER_S + wide / F32_FLOPS
        for ci in (14, 18, 22)), rel=1e-12)
    assert densestack.cat_bytes(shapes[1]) == 4 * n * (14 + 18 + 22 + 26)
    assert densestack.stacks(dict(cfg, denseblock=False), B=1, T=9) == []


# ---------------------------------------------------------------------------
# the readers, on a synthetic profile
# ---------------------------------------------------------------------------

OFFSET_US = 500.0      # the profiler's clock less the program's, in us
CAT = ("void at::native::(anonymous namespace)::CatArrayBatchedCopy_"
       "vectorized<at::native::(anonymous namespace)::OpaqueType<4u>, "
       "unsigned int, 2, 128, 1, 16, 4>(char*)")
WRAP = ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<"
        "at::native::(anonymous namespace)::OpaqueType<4u>, unsigned int, "
        "4, 64, 64>(char*)")
LONE = "Memcpy DtoD (Device -> Device)"
# a kernel whose name holds the concatenation kernel's, not at its start
NOT_CAT = "void other::CatArrayBatchedCopy_like(float*)"


def span(i, name, start_us, end_us, parent=None, **counts):
    """A program span whose times are given on the profiler's clock."""
    from audio_key_estimation_torch.utils.profiling import Span
    return Span(i, name, int((start_us - OFFSET_US) * 1e3),
                int((end_us - OFFSET_US) * 1e3), parent, None, counts)


def model_cfg():
    return dict(json.loads((harness.HERE / "configs" / "pcn_denseblock.json")
                           .read_text())["model"], reference="dense",
                bins_per_octave=36)


def shapes():
    return densestack.stacks(model_cfg(), B=4, T=9)


def synthetic(cat_bytes=None, convs=6, extra=False):
    """Two calls of the three dense stacks, each launching, 10 us apart:
    a lone copy (10 us on the device), then per layer a conv (100 us)
    and, from the second layer, a concatenation (20 us); a pitch-class
    stack a wrap (5 us) before each conv; and its block's output
    concatenation (20 us) 3 us before its span closes. Each call's last
    launch comes 5 us before its akx.model span closes, so the spans are
    placed 5 us early and the output concatenations fall out. With
    `extra`, the first stack launches two concatenations more, so that
    its placed span holds one more than its geometry gives even without
    its output's. Returns
    (profile, spans, each stack's (device us, block concatenation
    us))."""
    rows, ranges, found, want = [], [], [], []
    cat_bytes = cat_bytes or [densestack.cat_bytes(g) for g in shapes()]
    for c, at in enumerate((1000.0, 21000.0)):
        ranges.append(("bench.model", at, at + 9000.0))
        found.append(span(10 * c, "akx.model", at + 10.0, at + 8990.0))
        for k, g in enumerate(shapes()):
            lo = at + 100 + 3000 * k
            launches = [(LONE, 10.0)] + [(CAT, 20.0)] * (2 * extra * (k == 0))
            for i in range(g["layers"]):
                if i:
                    launches.append((CAT, 20.0))
                for _ in range(2):
                    if g["equivariant"]:
                        launches.append((WRAP, 5.0))
                    launches.append(("conv", 100.0))
            launches.append((CAT, 20.0))
            t = lo + 5
            for name, dur in launches:
                rows.append(Row(name, 9e4 + t, 9e4 + t + dur, t))
                t += 10
            found.append(span(10 * c + 1 + k, "akx.stack", lo, t - 7,
                              10 * c, convs=convs, res_blocks=0,
                              dense_layers=g["layers"],
                              cat_bytes=cat_bytes[k]))
            # a foreign concatenation between the stacks
            rows.append(Row(NOT_CAT, 9e4 + t + 50, 9e4 + t + 80, t + 50))
            rows.append(Row(CAT, 9e4 + t + 100, 9e4 + t + 130, t + 100))
            want.append((sum(d for _, d in launches),
                         sum(d for n, d in launches if n in (LONE, CAT))))
        rows.append(Row("sigmoid", 9e4 + at + 8990, 9e4 + at + 8991,
                        at + 8990.0 - 5.0))
    return (Profile(sorted(rows, key=lambda r: r.start_us), sorted(ranges),
                    1.0), found, want)


def readings(profile):
    return SimpleNamespace(
        profile=profile, call_minutes=2.0, model=model_cfg(),
        geometry={"cqts": [{"B": 4, "L": 9 * HOP - 1, "hop": HOP}]})


def readers(repo):
    ctx = harness.context(repo, CELL, 1, "cpu")
    return (harness.reader(ctx, "dense_stack_roofline"),
            harness.reader(ctx, "dense_cat_share"))


def test_the_readers_take_back_each_stacks_last_launch(repo, monkeypatch):
    from audio_key_estimation_torch.utils import profiling
    profile, found, want = synthetic()
    monkeypatch.setattr(profiling, "spans", lambda: found)
    placed = densestack.placed(profile, found, shapes())
    assert [(g["name"], len(rows)) for _, g, rows in placed] == [
        (g["name"], 1 + 2 * g["layers"] * (2 if g["equivariant"] else 1)
         + g["layers"]) for g in shapes()] * 2
    assert all(rows[-1].name == CAT for _, _, rows in placed)
    # the block's copies: the lone copy, then a concatenation before each
    # later layer and the output; the wraps left out
    assert [[r.name for r in densestack.block_concatenations(g, rows)]
            for _, g, rows in placed] == [[LONE] + [CAT] * g["layers"]
                                          for g in shapes()] * 2
    roofline, cat_share = readers(repo)
    device_us = sum(d for d, _ in want)
    bound_s = 2 * sum(densestack.stack_bound(g)["bound_s"] for g in shapes())
    assert roofline.read(readings(profile)) == pytest.approx(
        100.0 * bound_s / (device_us / 1e6))
    assert cat_share.read(readings(profile)) == pytest.approx(
        100.0 * sum(c for _, c in want) / device_us)
    for mod in (roofline, cat_share):
        assert (mod.LAYER, mod.UNIT, mod.MOVES, mod.SOURCE) == (
            "conv stacks (models.blocks.ConvStack)", "%",
            "device_audio_min_per_s", "device_trace")


@pytest.mark.parametrize("case", ["cat_bytes", "convs", "no stack spans",
                                  "no model span", "a stack missing",
                                  "an extra concatenation"])
def test_the_readers_give_nothing_where_the_spans_disagree(repo, monkeypatch,
                                                           case):
    """Another cat_bytes (a stack of another shape than the bound's),
    other convs, a program that records no akx.stack (the parent's
    records no dense counts) or no akx.model, a call that lacks one of
    its dense spans, and a stack that holds more concatenation launches
    than its geometry gives."""
    from audio_key_estimation_torch.utils import profiling
    n = [densestack.cat_bytes(g) for g in shapes()]
    profile, found, _ = synthetic(
        cat_bytes=[n[0], n[1] + 4, n[2]] if case == "cat_bytes" else None,
        convs=5 if case == "convs" else 6,
        extra=case == "an extra concatenation")
    found = {"no stack spans": [s for s in found if s.name != "akx.stack"],
             "no model span": [s for s in found if s.name != "akx.model"],
             "a stack missing": [s for s in found if s.id != 2]}.get(
        case, found)
    monkeypatch.setattr(profiling, "spans", lambda: found)
    roofline, cat_share = readers(repo)
    assert cat_share.read(readings(profile)) is None
    assert roofline.read(readings(profile)) is None


def test_the_concatenation_rows_are_anchored():
    assert densestack.is_cat(Row(CAT, 0, 1, 0))
    assert densestack.is_cat(Row(WRAP, 0, 1, 0))
    assert not densestack.is_cat(Row(NOT_CAT, 0, 1, 0))
    assert not densestack.is_cat(Row(LONE, 0, 1, 0))


def test_a_pitch_class_stacks_block_copies_leave_out_its_wraps():
    """Two layers: the lone copy, two wraps, the second layer's
    concatenation, two wraps, the output's; and a host-to-device copy
    that is no concatenation. A Pitch2Pitch stack wraps nothing."""
    names = [LONE, WRAP, WRAP, CAT, WRAP, WRAP, CAT,
             "Memcpy HtoD (Pageable -> Device)"]
    rows = [Row(n, 0, 1, t) for t, n in enumerate(names)][::-1]
    pc = {"layers": 2, "equivariant": True}
    assert [r.launch_us for r in densestack.block_concatenations(pc, rows)
            ] == [0, 3, 6]
    p2p = {"layers": 2, "equivariant": False}
    rows = [Row(n, 0, 1, t) for t, n in enumerate([LONE, CAT, CAT])]
    assert [r.launch_us for r in densestack.block_concatenations(p2p, rows)
            ] == [0, 1, 2]
