"""Tests of the benchmark itself, on the CPU at tiny sizes:

    python -m pytest benchmark/tests -q

Tests that need a CUDA card carry the `card` marker and skip inside the
test where none is present (`card` fixture)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the H100")
    return "cuda:0"
