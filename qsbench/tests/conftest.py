"""The benchmark's own tests: on the CPU, at SF0.01; those that need a
CUDA card are marked `cuda` and skip inside a fixture where torch finds
none.

    python -m pytest qsbench/tests
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skipped where torch finds none")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")
