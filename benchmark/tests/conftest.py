"""Tests of the benchmark's harness, on the CPU; the ``cuda`` ones run only
where a card is (``python -m pytest benchmark/tests`` on the card's
machine runs them too)."""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def cuda_device():
    """The first card; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the control runs in TF32, which "
                    "only the card has)")
    return torch.device("cuda", 0)
