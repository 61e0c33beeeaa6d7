"""On the card, at a cell's own size: the control (the reference in
bfloat16 in the program's place) is not correct under the cell's limits.
Run with ``python -m pytest benchmark/tests -m card`` on a machine with a
CUDA card; skips elsewhere."""

import pytest

from benchmark import checks, control


@pytest.mark.card
@pytest.mark.parametrize("cell", ["train_vanilla_7k", "serve_refined_highpoly"])
def test_the_control_fails_at_the_cells_size(card, cell):
    r = control.readings(cell, 3_000_000_321, card)
    ok, compared = checks.judge(r["bfloat16"], r["limits"])
    assert not ok, compared
