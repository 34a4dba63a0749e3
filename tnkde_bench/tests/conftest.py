"""Tests of the benchmark's harness (CPU, small sizes), run with
``python -m pytest tnkde_bench/tests`` from the root of the checkout. Tests
marked ``chip`` need an NVIDIA GPU and skip without one; the decision is
made inside the ``cuda`` fixture, never at import."""
import os
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA GPU (runs on the card only)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card's run of this check")
    return "cuda"
