"""The grid plan of the port's 3D wgrad kernel at the flagship's three
deepest levels, bf16 and float32: every (co, ci, tap, D plane, H row)
covered once (tests/test_torch_wgrad_plan.py)."""
import pytest
import torch

from test_torch_wgrad_plan import FLAGSHIP, check_plan

torch.set_num_threads(1)


@pytest.mark.parametrize("ci,co,sp", FLAGSHIP[11:])
def test_plan_covers_each_output_and_position_once(ci, co, sp):
    check_plan(ci, co, sp, 3, True)
    check_plan(ci, co, sp, 3, False)
