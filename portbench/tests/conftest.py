"""Fixtures of the benchmark's own tests. Whether there is a card is
decided here, in a fixture, never while a module is imported."""

from __future__ import annotations

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH)
for p in (REPO, BENCH, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """The first CUDA card; the test skips where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip: python -m pytest -m cuda_only portbench/tests)")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny_root(tmp_path):
    from tinybench import make_tiny_root

    return make_tiny_root(str(tmp_path / "bench"))

