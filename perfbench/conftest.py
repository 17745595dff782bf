"""pytest settings of the benchmark's own tests (``perfbench/tests``).

Tests that need a CUDA card carry the ``chip`` marker and take the
``card`` fixture, which decides whether a card exists when the test runs
(never while a module is imported) and skips it where there is none.
Run them on the card with ``python3 -m pytest perfbench/tests -m chip``.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)
