"""Fixtures of the benchmark's own tests (run them with
`python -m pytest gjbench/tests`; the repository's `pytest tests/` does not
collect them)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A checkout-like directory with the tiny cells of `_tiny.py`."""
    from gjbench.tests import _tiny
    return _tiny.make_root(str(tmp_path_factory.mktemp("tiny")))


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda:0"
