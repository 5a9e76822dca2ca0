"""pytest settings of the benchmark's own tests: the ``card`` marker (tests
that need a CUDA card skip, inside a fixture, where there is none) and one
torch thread a test process."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped (inside a fixture) without one")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is false")
    return torch.cuda.get_device_name(0)
