"""On the card (skipped elsewhere): each cell at its own size is correct,
and every control of it, the reference put in the program's place in the
next lower precision (and, for training, the faults read by the
reference), fails a limit.

    python -m pytest -m cuda portbench/tests/test_portbench_card.py
"""

import pytest

from portbench import harness
from portbench.tests.conftest import SEED

WINDOWS = {"tag_continuous.train": 1, "flagship.sim": 600}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(WINDOWS))
def test_a_cell_on_the_card_is_correct_and_its_controls_are_not(card, cell):
    line = harness.execute(cell, SEED, 1.0, False, device=str(card),
                           overrides={"traffic": {"units": WINDOWS[cell]}},
                           control=True, settle=False)
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    limits = {n: c["limit"] for n, c in line["checks"].items()}
    for kind, numbers in line["control"].items():
        assert [n for n, v in numbers.items() if v > limits[n]], \
            (kind, numbers)
