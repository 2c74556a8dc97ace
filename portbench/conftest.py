"""Test settings of the benchmark's own tests (`python -m pytest portbench`).

Card tests carry the `cuda` marker and take the `card` fixture, which
decides whether there is a card when the test runs, never at import.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skipped where there is none"
    )


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
