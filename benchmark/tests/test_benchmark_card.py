"""On the card (skipped without one): each cell, cut to a tiny size, runs
through the harness on CUDA and comes out correct."""
from __future__ import annotations

import pytest

from benchmark import harness
from conftest import make_tiny

CELLS = ["mrunet3d.solo256", "mrunet3d_f32.solo256", "mrunet3d.lanes8"]


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_on_the_card(tmp_path, cuda, cell):
    import io
    import json
    name = make_tiny(tmp_path, cell)
    out = io.StringIO()
    rc = harness.run(["--workload", name, "--seed", str(2 ** 31 + 1), "--seconds", "0",
                      "--trace", "1"], extra_dir=tmp_path, out=out)
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and res["correct"] and res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
