"""PyTorch port: the data-parallel train step of the local and
multi-scale programs against the JAX package's sharded mesh, on the CPU.

tests/test_torch_ddp.py's cases for the other two programs of
tests/test_cli.py:142: the local program (genre on, per-window labels,
rows whose valid windows differ) and the multi-scale ensemble (mel and
mel2), one step at micro-batch 8 x acc_grad 2 on 2 and 4 gloo ranks
against the JAX step computing in float64 over the 8-device mesh and on
one device, and against the port's single-process step, at that file's
bars; every rank's parameters equal bit for bit.
"""

import pytest

from test_torch_ddp import (WORLDS, check_against_jax,
                            check_against_single_process, check_ranks_agree,
                            run_ranks)

NAMES = ("local", "multi_scale")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(tmp_path_factory, NAMES)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("against", ["mesh", "single"])
@pytest.mark.parametrize("name", NAMES)
def test_sharded_step_matches_jax(ranks, world, name, against):
    check_against_jax(ranks, world, name, against)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", NAMES)
def test_ranks_agree_bit_for_bit(ranks, world, name):
    check_ranks_agree(ranks, world, name)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", NAMES)
def test_sharded_step_matches_single_process(ranks, world, name):
    check_against_single_process(ranks, world, name)
