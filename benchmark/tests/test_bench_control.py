"""The check's control fails it: the reference in the system's place,
computed in TF32 where the configuration states IEEE float32, at each
cell's own size, on three seeds; and so does each fault a training cell
can have, planted in the reference. On the card:

    python -m pytest benchmark/tests -m card
"""

import pytest

from benchmark.control import control

CELLS = ["default.files", "multi_scale.resident", "default.resident",
         "default.train"]
STAND_INS = [(c, "tf32") for c in CELLS] + [("default.train", "half"),
                                             ("default.train", "frozen")]


@pytest.mark.card
@pytest.mark.parametrize("cell,stand_in", STAND_INS)
def test_the_control_fails(card, repo, cell, stand_in):
    from benchmark import precision
    precision.ieee()
    for seed in (71, 72, 2**31 + 13):
        res = control(repo, cell, seed, stand_in)
        assert not res["correct"], (cell, stand_in, seed, res["checks"])
