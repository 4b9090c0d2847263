"""Tests of the benchmark: ``python -m pytest benchmark/``.

Tests marked ``card`` need a CUDA card and skip elsewhere; whether there
is one is decided in the ``card`` fixture, never while a module is
imported."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (run on the chip: pytest benchmark/ -m card)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)
