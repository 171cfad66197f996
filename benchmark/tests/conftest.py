"""The benchmark's CPU tests: run from the repository's root with
``python -m pytest benchmark/tests -q``.  Tests that need the card carry
the ``cuda`` marker and skip where there is none, deciding inside the
test."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def manifest():
    import harness

    return harness.load_json(ROOT / "BENCHMARK.json")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
