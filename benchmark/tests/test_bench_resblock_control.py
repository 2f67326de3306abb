"""The check's control fails the residual-stack cell: the reference in
the system's place, computed in TF32 where the configuration states IEEE
float32, at the cell's own size, on three seeds. The cell joined the
benchmark after `test_bench_control.py`'s fixed list; on the card:

    python -m pytest benchmark/tests -m card
"""

import pytest

from benchmark.control import control


@pytest.mark.card
@pytest.mark.parametrize("seed", [71, 72, 2**31 + 13])
def test_the_control_fails_the_residual_cell(card, repo, seed):
    from benchmark import precision
    precision.ieee()
    res = control(repo, "resblock.resident", seed, "tf32")
    assert not res["correct"], (seed, res["checks"])
