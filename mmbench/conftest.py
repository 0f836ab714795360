"""pytest settings of the benchmark's own tests (``pytest mmbench/tests``).

``card`` marks a test that needs a CUDA card; the ``cuda_card`` fixture
decides whether one is there, when the test runs (never at import), and
skips the test without one.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped on a host without one")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return torch.device("cuda", 0)
