"""The benchmark's tests: ``python3 -m pytest portbench/tests -q`` from the
root of the checkout. Tests that need a CUDA card carry the ``card`` marker
and take the ``card`` fixture, which skips them where there is none."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card only")
    return torch.device("cuda", 0)
