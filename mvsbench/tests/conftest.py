"""The harness's tests: ``python -m pytest mvsbench/tests -q`` from the
checkout's root. Tests that need an NVIDIA card carry the ``cuda`` marker
(registered in pyproject.toml) and take the ``card`` fixture, which skips
them where there is none."""

import os
import sys

import pytest

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)
