"""The wgrad kernel's tuned grids across processes (ops/wgrad.py and the
solver's checkpoint): a grid's JSON form, ``tuned_plans`` / ``pin_plans``,
the checkpoint's ``__meta__`` entry, the resume that pins it, and the
deterministic cuDNN flag of a checkpointed solve. Pure Python: no JAX."""
import json

import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu_torch import Config, DIPSolver
from deep_prior_interpolation_tpu_torch.ops import wgrad as WG

torch.set_num_threads(1)

# flagship shapes (Ci, Co, D, H, W, bf16): the heaviest full-resolution one,
# a float32 one, a deep one and the bottleneck's
SHAPES = [(67, 4, 256, 128, 128, True), (25, 16, 256, 128, 128, False),
          (212, 128, 32, 16, 16, True), (142, 213, 16, 8, 8, True)]


@pytest.fixture
def tuned(monkeypatch):
    """An empty grid cache for the test, as in a fresh process."""
    monkeypatch.setattr(WG, "_tuned", {})
    return WG._tuned


@pytest.mark.parametrize("shape", SHAPES)
def test_every_candidate_grid_survives_its_json_form(shape):
    plans = WG._plans(*shape[:5], 3, shape[5])
    assert len(plans) > 1
    for pl in plans:
        back = WG.Plan.from_json(json.loads(json.dumps(pl.to_json())))
        assert back == pl and type(back.bf16) is bool


def _entries(shape, aligned=True):
    ci, co, d, h, w, bf16 = shape
    dt = "bfloat16" if bf16 else "float32"
    return [{"key": [[1, ci, d, h, w], [1, co, d, h, w], 3, dt, dt, aligned],
             "plan": pl.to_json()} for pl in WG._plans(ci, co, d, h, w, 3, bf16)[1:2]]


def test_pinned_grids_are_kept_and_listed(tuned):
    entries = [e for shape in SHAPES for e in _entries(shape)] + _entries(SHAPES[0], False)
    assert WG.pin_plans(json.loads(json.dumps(entries))) == len(entries)
    assert len(tuned) == len(entries)
    assert WG.tuned_plans() == entries
    # the kernel's arguments: TMA only for aligned bases, then the plan and
    # the lanes (one)
    pl, args = tuned[((1, 67, 256, 128, 128), (1, 4, 256, 128, 128), 3, torch.bfloat16,
                      torch.bfloat16, False)]
    assert args[1] == 0 and list(args)[3:-1] == list(pl)[WG.Plan._fields.index("sc"):]
    assert args[-1] == 1


def test_a_grid_this_planner_does_not_list_is_not_pinned(tuned):
    e = _entries(SHAPES[0])[0]
    e["plan"] = dict(e["plan"], hb=e["plan"]["hb"] + 100)
    with pytest.warns(UserWarning, match="timed again"):
        assert WG.pin_plans([e]) == 0
    assert not tuned


def _tiny_3d():
    cfg = Config(datadim="3d", epochs=4, scan_chunk=2, inputdepth=4, filters=[4, 8],
                 skip=[4], gain=1.0, upsample="linear")
    rng = np.random.RandomState(0)
    img = rng.randn(8, 8, 8, 1).astype(np.float32)
    mask = (rng.rand(1, 8, 8, 1) > 0.5).astype(np.float32).repeat(8, 0)
    return cfg, img, mask


def test_checkpoint_carries_the_grids_and_the_resume_pins_them(tuned, tmp_path, monkeypatch):
    entries = _entries(SHAPES[2]) + _entries(SHAPES[1])
    WG.pin_plans(entries)
    cfg, img, mask = _tiny_3d()
    path = str(tmp_path / "state.npz")
    half = Config(**{**cfg.to_dict(), "epochs": 2})
    DIPSolver(half, device="cpu").solve(img, mask, seed=0, checkpoint_path=path,
                                        checkpoint_every=1)
    with np.load(path) as z:
        meta = json.loads(str(z["__meta__"]))
    assert meta["wgrad_plans"] == entries

    tuned.clear()  # a fresh process
    seen = []
    real = WG.pin_plans

    def spy(e):
        seen.append(e)
        return real(e)
    monkeypatch.setattr(WG, "pin_plans", spy)
    resumed = DIPSolver(cfg, device="cpu").solve(img, mask, seed=0, checkpoint_path=path)
    assert seen == [entries] and WG.tuned_plans() == entries
    straight = DIPSolver(cfg, device="cpu").solve(img, mask, seed=0)
    np.testing.assert_array_equal(resumed.history.loss, straight.history.loss)
    np.testing.assert_array_equal(resumed.out_best, straight.out_best)


def test_a_checkpointed_solve_runs_with_deterministic_cudnn(tmp_path, monkeypatch):
    cfg, img, mask = _tiny_3d()
    flags = []
    real = DIPSolver._step

    def spy(self, *a, **k):
        flags.append(torch.backends.cudnn.deterministic)
        return real(self, *a, **k)
    monkeypatch.setattr(DIPSolver, "_step", spy)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    DIPSolver(cfg, device="cpu").solve(img, mask, seed=0)
    DIPSolver(cfg, device="cpu").solve(img, mask, seed=0,
                                       checkpoint_path=str(tmp_path / "c.npz"))
    assert flags == [False] * 4 + [True] * 4
    assert torch.backends.cudnn.deterministic is False
