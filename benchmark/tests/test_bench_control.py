"""The control of each cell (the plain reference with one guarantee of
the configuration broken, in the program's place) comes out not
correct: on the CPU at a size that a test run holds, and, marked for the
card, at the cell's own size on three seeds."""

import pytest

from benchmark import harness
from benchmark.tests._tiny import CELLS, ROOT, SEED, tiny


def _failed(checks):
    return [k for k, c in checks.items() if c["value"] > c["limit"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    c = harness.Cell(cell, ROOT, tiny(cell))
    assert _failed(c.entry().control(c, SEED, "cpu", lambda m: None))


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_at_the_cells_size_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    c = harness.Cell(cell, ROOT)
    for seed in (SEED, SEED + 2, SEED + 4):
        assert _failed(c.entry().control(c, seed, "cuda", lambda m: None))
