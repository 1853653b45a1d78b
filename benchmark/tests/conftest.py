"""The benchmark's own tests: CPU tests at small sizes, and card tests (marked ``card``)
that skip without a card.  Run them from the repository's root:

    python -m pytest benchmark/tests -q
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line('markers', 'card: needs a CUDA card; skips without one')


@pytest.fixture
def card():
    """The card's device; skips the test where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', 0)
