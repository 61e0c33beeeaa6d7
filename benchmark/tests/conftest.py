"""CPU tests of the benchmark (``python -m pytest benchmark/tests`` from the
root of the repository). Tests that need a CUDA card carry the ``card``
marker and decide in the ``card`` fixture, never at import."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


# Small sizes of each configuration for the CPU: the shapes of the cells,
# the scale cut.
SMALL = dict(
    vanilla_7k=dict(capacity=4096, alive=4000, views=4, height=72, width=100),
    refined_highpoly=dict(rings=30, segments=60, views=4, height=72, width=100),
)
