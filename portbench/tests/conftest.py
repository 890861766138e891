"""The benchmark's own tests: `python -m pytest portbench/tests -q` from
the repository root. Tests marked `cuda` need the card and skip
elsewhere; whether a card is present is decided in the `card` fixture,
never at import."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    import torch
    torch.set_num_threads(min(4, torch.get_num_threads()))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
