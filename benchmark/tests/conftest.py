"""CPU tests of the benchmark (run: ``python -m pytest benchmark/tests``).

Tests marked ``card`` need a CUDA device; each decides inside a fixture,
never while modules are imported, and skips with a reason on a machine
without one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
