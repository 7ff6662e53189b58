"""The benchmark's CPU tests. Tests that need a card take the ``card``
fixture (marker ``card``), which skips them where none is visible."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; none is visible")
    return torch.device("cuda", 0)


@pytest.fixture
def one_thread():
    """Torch's CPU pool at one thread (pytest may run files in parallel)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
