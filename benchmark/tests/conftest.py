"""Settings of the benchmark's own tests (run them with
`python -m pytest benchmark/tests -q`): the `card` marker of tests that
need a CUDA card, which decide in a fixture whether one is there."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
