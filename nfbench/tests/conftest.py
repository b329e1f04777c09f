"""The benchmark's own tests. CPU tests run anywhere; tests marked `card`
need a CUDA device and skip without one, decided inside the `card`
fixture."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (runs the benchmark on it)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs the benchmark on the card")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def bench():
    from nfbench import run

    return run.load_bench()
