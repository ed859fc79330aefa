"""The benchmark's tests: ``python -m pytest stereo_bench/tests -q`` from
the checkout's root.  Tests marked ``cuda`` need a card and skip without
one, inside the ``card`` fixture."""

import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
