"""The benchmark's own tests: on the CPU at small sizes, and, marked
``cuda``, on a card.  Run from the repository's root:

    python -m pytest nufftbench/tests -q

They import neither JAX nor the JAX package."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU and nvcc (skips without one)")


@pytest.fixture
def card():
    """Skips a test without a CUDA card (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


@pytest.fixture
def tiny():
    """``tiny(name, shape, density)``: the cell ``name`` of BENCHMARK.json
    on a smaller grid (and, given, another density), with the same files,
    mix and limits otherwise."""
    from nufftbench import harness

    def make(name: str, shape=(16, 16, 16), density=None):
        cell = harness.load_cell(ROOT, name)
        cell.config = dict(cell.config, shape=list(shape))
        if density is not None:
            cell.traffic = dict(cell.traffic, density=density)
        return cell

    return make
