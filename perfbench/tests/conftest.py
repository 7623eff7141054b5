"""The benchmark's own tests (not collected by the repository's test
run, whose ``testpaths`` is ``tests/``):

    PYTHONPATH=src python -m pytest -q perfbench/tests

Tests marked ``card`` need a CUDA device and skip without one; on a
machine with the card the same command runs them."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")
