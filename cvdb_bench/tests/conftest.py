"""The benchmark's own tests (run as ``python -m pytest cvdb_bench/tests``
from the root of the repository). Tests marked ``card`` need a CUDA card
and skip elsewhere; whether there is one is decided inside the ``card``
fixture, never while a module is imported."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
