"""The benchmark's CPU tests: ``python -m pytest -q perfbench/tests``.

Tests marked ``card`` need a CUDA device and skip without one; the
decision is taken in the ``card`` fixture, never at import."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device (skips without)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny():
    """A tiny traffic mix at the configurations' published widths."""
    return {"nodes": 40, "steps": 16, "edges_per_snapshot": 100,
            "generator": "uniform", "ranks": 1, "lane_multiple": 128}
