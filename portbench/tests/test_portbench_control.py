"""The control, the plain reference computed in fp8 in the program's place,
reads ``correct`` false. On the card at each cell's own size on three
seeds (``-m card``); on the CPU at tiny widths, its readings exceed the
bf16 program's on the numbers that separate there."""

import pytest
from conftest import CELLS, tiny

from portbench import control
from portbench.harness import core

SEEDS = (3_100_000_001, 3_100_000_002, 3_100_000_003)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(card, cell):
    limits = core.Context(cell, 0, 0.0, False).limits
    for seed in SEEDS:
        row = control.readings(cell, seed, 2.0, card)
        assert all(v <= limits[k] for k, v in row["program"].items()), row
        assert any(v > limits[k] for k, v in row["control"].items()), row


@pytest.mark.parametrize("cell", ("crop50_train_b8", "scene100_act_b1"))
def test_control_reads_above_the_program_on_the_cpu(cell):
    row = control.readings(cell, 4, 0.3, "cpu", tiny(cell))
    assert row["control"]["q_err"] > 2 * row["program"]["q_err"], row
