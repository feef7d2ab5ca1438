"""The comparison that decides ``correct``: a sound run of each cell (cut to
a tiny size on the CPU, its limits as they are) comes out correct, and a run
with the timed path broken underneath (``faults.py``: a step that returns
its state unchanged; half of the batch left out; a step's loss altered where
it is made) comes out not correct."""
from __future__ import annotations

import pytest

from benchmark import faults
from conftest import make_tiny, run_cpu

CELLS = ["mrunet3d.solo256", "mrunet3d_f32.solo256", "mrunet3d.lanes8"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", (None,) + faults.NAMES)
def test_fault_makes_a_run_incorrect(tmp_path, cell, fault):
    name = make_tiny(tmp_path, cell)
    if fault is None:
        rc, res, _ = run_cpu(tmp_path, name)
        assert rc == 0 and res["correct"], res["check"]
        return
    with faults.planted(fault, lanes=cell.endswith("lanes8")):
        rc, res, _ = run_cpu(tmp_path, name)
    assert rc == 0 and not res["correct"], res["check"]
