"""The benchmark's own tests (CPU; those that need a card are marked ``cuda``
and skip here). Run from the repository root:

    python -m pytest portbench/tests -q
"""
import pytest

from benchutil import shrink


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def tiny():
    """tiny(workload, seed, seconds=0.5, trace=False) -> a shrunk CPU cell."""
    from harness import cell as C

    def make(workload, seed=2**31 + 11, seconds=0.5, trace=False):
        return shrink(C.make_cell(C.benchmark(), workload, seed, seconds, trace, "cpu"))

    return make

