"""The grid plan of the port's 3D wgrad kernel at the edge shapes of
tests/test_torch_cuda_wgrad.py and tests/test_torch_cuda.py (flattened W = 8
and 16 rows, partial bands, D < k, wide channel tiles, swapped roles, k = 5
and 7, rows of other widths) and float32 at the flagship's 25 -> 16: every
(co, ci, tap, D plane, H row) covered once (tests/test_torch_wgrad_plan.py)."""
import pytest
import torch

from test_torch_wgrad_plan import check_plan

torch.set_num_threads(1)


@pytest.mark.parametrize("ci,co,sp,k,bf16", [
    (24, 10, (6, 8, 8), 3, True), (9, 5, (4, 20, 32), 3, True),
    (6, 4, (2, 8, 16), 3, True), (6, 4, (1, 8, 16), 3, True),
    (37, 35, (4, 8, 16), 3, True), (8, 13, (4, 16, 32), 3, True),
    (6, 3, (7, 6, 16), 5, True), (4, 5, (9, 8, 16), 7, True),
    (9, 5, (5, 6, 20), 3, True), (25, 16, (9, 7, 130), 3, True),
    (3, 2, (5, 9, 300), 3, False), (105, 35, (8, 16, 16), 3, False),
    (7, 9, (5, 9, 12), 5, False), (4, 2, (9, 8, 11), 7, False),
    (25, 16, (256, 128, 128), 3, False),
])
def test_plan_covers_each_output_and_position_once(ci, co, sp, k, bf16):
    check_plan(ci, co, sp, k, bf16)
