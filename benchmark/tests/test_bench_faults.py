"""The check catches what a broken timed path would give: the whole run
(without the look for a card) on tiny cells on the CPU, with the system
broken underneath: an answer altered where it is produced (a clip's
key), half of the batch left out with the mean of the rest in its place,
and, for the training cell, a step that returns its state unchanged.
No cell runs on more than one chip, so none can lose an exchange."""

import pytest
import torch

import bench_tiny
from benchmark.harness import run_cell

CELLS = sorted(bench_tiny.TINY_CELLS)


@pytest.fixture
def tiny(checkout):
    bench_tiny.add_tiny_cells(checkout)
    return checkout


def altered(forward):
    """Row 0's key read as another key: its pitch classes rolled by one."""
    def run(self, *a, **kw):
        key, *rest = forward(self, *a, **kw)
        key = key.clone()
        key[0] = key[0].roll(1)
        return (key, *rest)
    return run


def half_left_out(forward):
    """The first half of the rows run; the rest get their mean."""
    def run(self, mel, seq_length=None):
        n = mel.shape[0]
        h = max(n // 2, 1)
        outs = forward(self, mel[:h],
                       None if seq_length is None else seq_length[:h])
        return tuple(torch.cat([o, o.mean(0, keepdim=True).expand(
            n - h, *o.shape[1:])]) for o in outs)
    return run


def run(root, cell, seed=2**31 + 3):
    return run_cell(root, cell, seed, 0.3, False, "cpu")


def unchanged(step):
    """Adam's step does nothing: the state comes back as it went in."""
    def run(self, *a, **kw):
        return None
    return run


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tiny, cell):
    res = run(tiny, cell)
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", [altered, half_left_out])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_is_not_correct(tiny, cell, fault, monkeypatch):
    from audio_key_estimation_torch.models import pitchclassnet
    monkeypatch.setattr(pitchclassnet.PitchClassNet, "forward",
                        fault(pitchclassnet.PitchClassNet.forward))
    res = run(tiny, cell)
    assert not res["correct"], res["checks"]


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(
        tiny, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        unchanged(torch.optim.Adam.step))
    res = run(tiny, "tiny.default.train")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_reference_in_the_systems_place_is_correct(tiny, cell):
    """The control's path with no lower precision (TF32 does not exist on
    the CPU): the reference stands in and the check finds it correct."""
    res = run_cell(tiny, cell, 2**31 + 5, 0.3, False, "cpu",
                   stand_in="tf32")
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["half", "frozen"])
def test_a_fault_planted_in_the_reference_is_not_correct(tiny, fault):
    res = run_cell(tiny, "tiny.default.train", 2**31 + 5, 0.3, False,
                   "cpu", stand_in=fault)
    assert not res["correct"], res["checks"]
