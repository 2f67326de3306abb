"""The benchmark's own tests: `python -m pytest benchmark/tests -q`.

Tests that need the card carry the `card` marker and take the `card`
fixture, which decides at run time, never at import, whether there is
one; here on a machine without CUDA they skip with a reason.
"""

import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU; skips without CUDA")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs the card (CUDA is not available here)")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def repo() -> Path:
    return REPO


@pytest.fixture
def checkout(tmp_path):
    """A checkout holding BENCHMARK.json and a copy of benchmark/, for
    tests that add files to it."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path
