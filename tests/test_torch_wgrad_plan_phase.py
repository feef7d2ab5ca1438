"""The wgrad kernel's grid plans at the 9 conv shapes that only the
phase-space flagship gives it (MulResUnet 3D, filters [16..256], phase
levels 2: the phase convs of resolutions 0 and 1 on their (128, 64, 64) and
(64, 32, 32) phase grids, channels x 8): the gate admits each, ``_plans``
yields candidates in bf16 and float32, and every sixth bf16 candidate
covers every (co, ci, tap, D plane, H row) exactly once
(tests/test_torch_wgrad_plan.py's check; the 270 candidates of the 9 shapes
take ~65 s on one CPU core, so a spread of 5 a shape stands for them here,
and the card holds every candidate against the plain version in
tests/test_torch_cuda_phase.py)."""
import pytest
import torch

from deep_prior_interpolation_tpu_torch.ops import wgrad as WG
from test_torch_wgrad_plan import _check_one

torch.set_num_threads(1)

_A, _B = (128, 64, 64), (64, 32, 32)
# (Ci, Co, phase spatial) of the phase convs, channels x 8
PHASE_SHAPES = [(536, 32, _A), (200, 128, _A), (200, 8, _A), (64, 104, _A), (32, 64, _A),
                (1096, 64, _B), (408, 256, _B), (136, 208, _B), (64, 136, _B)]


@pytest.mark.parametrize("ci,co,sp", PHASE_SHAPES)
def test_phase_shapes_are_admitted_and_planned(ci, co, sp):
    assert WG.wgrad_supported((1, ci) + sp, (co, ci, 3, 3, 3), 1, ((1, 1),) * 3)
    assert WG._plans(ci, co, *sp, 3, False)
    plans = WG._plans(ci, co, *sp, 3, True)
    assert len(plans) >= 1
    for pl in plans[::6]:
        _check_one(pl, sp, 3)
