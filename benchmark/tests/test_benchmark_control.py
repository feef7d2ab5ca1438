"""The control: the reference computed in the precision below the one each
configuration states (fp8 below bfloat16, TF32 below float32), put in the
program's place, fails the cell's limits (a tiny patch on the CPU; on the
card at the cells' own size by ``calibrate.py --control``)."""
from __future__ import annotations

import pytest

from benchmark import harness, traffic
from conftest import make_tiny

CELLS = ["mrunet3d.solo256", "mrunet3d_f32.solo256", "mrunet3d.lanes8"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [2 ** 31 + 3, 2 ** 32 + 17])
def test_control_is_not_correct(tmp_path, cell, seed):
    tiny = harness.load_cell(make_tiny(tmp_path, cell), tmp_path)
    c = tiny["config"]["config"]
    spec = harness.reference_net(tiny).spec()
    (prob,) = traffic.make_pool(tiny["traffic"], spec, c["gain"], c["initgain"], seed, "cpu")
    ref = harness.reference_lanes(tiny, prob, "cpu")
    control = harness.reference_lanes(tiny, prob, "cpu", quant=tiny["config"]["control"])
    readings = harness.compare(control, ref)
    limits = tiny["workload"]["limits"]
    assert any(readings[k] > v for k, v in limits.items()), readings
