"""Tests of the benchmark's own code. Run from the checkout's root:

    python3 -m pytest portbench/tests

Those marked `card` need a CUDA card and skip without one; the card is
looked for inside the `card` fixture, never while a module is imported."""

import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")
