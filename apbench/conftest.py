"""The benchmark's tests: ``card`` marks a test that needs a CUDA device;
it is skipped inside the ``card`` fixture where there is none."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (run on the chip)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the chip")
    return torch.device("cuda", 0)
