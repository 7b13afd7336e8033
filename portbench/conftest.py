"""pytest settings of the benchmark's own tests (``pytest portbench/tests``).

Tests that need the card carry the ``card`` marker and take the ``card``
fixture, which decides at run time, never at import, whether there is one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture(scope="session", autouse=True)
def few_threads():
    """Test workers share the machine's cores: four torch threads each."""
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(min(4, saved))
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: the benchmark's card tests run on the chip")
    return torch.device("cuda")
