"""The harness drives a whole run, with the timed path broken underneath,
and `correct` comes out false: the control (the reference in the next
precision below the configuration's, in the program's place) and each
fault the cell can have. A sound run comes out true."""

import pytest

from benchmark import run

CELLS = {"code1m.b256-k10": ("control", "stale", "half_batch", "half_rows",
                             "altered", "rescore_dropped"),
         "unixcoder-base.index-b128": ("control", "stale", "half_batch",
                                       "altered")}
CASES = [(c, f) for c, faults in CELLS.items() for f in (None,) + faults]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_turns_correct_false(cell, fault, tiny):
    result = run.run_cell(cell, 4242424242, 0.3, False, device="cpu",
                          overrides=tiny[cell], fault=fault)
    assert result["correct"] is (fault is None), result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_drivers_name_these_faults(cell, tiny):
    cfg = run.load_cell(cell, 1, "cpu", overrides=tiny[cell])
    driver = run.load_named("drivers", cfg.traffic["entry"])
    assert tuple(driver.FAULTS) == CELLS[cell]
