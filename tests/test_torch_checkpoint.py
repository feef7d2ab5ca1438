"""Checkpoint and resume (io/checkpoint.py and DIPSolver.solve), weights
files with their configuration gate, and snapshots.

On the CPU a resumed solve is bit for bit the straight one: the checkpoint
holds the whole state, the random generator's included. Snapshots are held
against one JAX solve (same canvas and initial weights, no per-step input
noise) at tests/test_torch_solver.py's tolerance for outputs."""
import os

import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu.config import Config as JaxConfig
from deep_prior_interpolation_tpu.engine import DIPSolver as JaxDIPSolver
from deep_prior_interpolation_tpu_torch import Config, DIPSolver
from deep_prior_interpolation_tpu_torch.config import write_args
from deep_prior_interpolation_tpu_torch.io import (load_checked, load_params,
                                                   load_solver_state, npz_path,
                                                   save_params, save_solver_state,
                                                   state_dict_to_jax_params)
from deep_prior_interpolation_tpu_torch.models import init_weights

torch.set_num_threads(1)

CASES = {
    "2d": (dict(datadim="2d", filters=[8, 16], skip=[4], save_every=3, pocs=True), (24, 16)),
    "3d-bf16": (dict(datadim="3d", filters=[4, 8], skip=[4], dtype="bfloat16",
                     fused_loss=True), (8, 8, 8)),
}


def _cfg(kind, **kw):
    base = dict(epochs=6, scan_chunk=3, inputdepth=4, gain=1.0, reg_noise_std=0.03)
    base.update(CASES[kind][0])
    base.update(kw)
    return Config(**base)


def _problem(spatial, seed=0):
    rng = np.random.RandomState(seed)
    grids = np.meshgrid(*[np.linspace(0, 1, n) for n in spatial], indexing="ij")
    img = np.sin(2 * np.pi * sum((k + 3) * g for k, g in enumerate(grids)))
    mask = np.repeat(rng.rand(1, *spatial[1:]) > 0.5, spatial[0], 0)
    return img[..., None].astype(np.float32), mask[..., None].astype(np.float32)


def _same_result(a, b):
    for f in a.history.FIELDS:
        np.testing.assert_array_equal(getattr(a.history, f), getattr(b.history, f))
    np.testing.assert_array_equal(a.out_best, b.out_best)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k


@pytest.mark.parametrize("kind", sorted(CASES))
def test_resume_is_bit_exact(tmp_path, kind):
    img, mask = _problem(CASES[kind][1])
    cfg = _cfg(kind)
    ckpt = str(tmp_path / "state")  # no suffix: '.npz' is added
    straight = DIPSolver(cfg, device="cpu").solve(img, mask, seed=1)
    cut = DIPSolver(Config(**{**cfg.to_dict(), "epochs": 3}), device="cpu").solve(
        img, mask, seed=1, checkpoint_path=ckpt, checkpoint_every=1)
    assert cut.iters_run == 3 and os.path.exists(ckpt + ".npz")
    resumed = DIPSolver(cfg, device="cpu").solve(img, mask, seed=1, checkpoint_path=ckpt,
                                                 checkpoint_every=1)
    assert resumed.iters_run == 6 and len(resumed.chunk_seconds) == 1
    _same_result(resumed, straight)
    if cfg.pocs:
        np.testing.assert_array_equal(resumed.pocs, straight.pocs)


def test_solver_state_round_trip_is_bit_exact(tmp_path):
    g = torch.Generator().manual_seed(5)
    state = {"params": torch.randn(50, generator=g), "count": torch.tensor(3, dtype=torch.int32),
             "out_best": torch.randn(1, 1, 4, 6, generator=g).to(torch.bfloat16),
             "done": torch.tensor(True), "lr": torch.tensor(1e-3), "rng": g.get_state()}
    path = save_solver_state(str(tmp_path / "s"), state, {"__meta__": np.asarray("{}")})
    assert path.endswith("s.npz")
    back = load_solver_state(path, state)
    for k, v in state.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    with pytest.raises(ValueError, match="shape"):
        load_solver_state(path, {"params": torch.zeros(49)})
    with pytest.raises(KeyError):
        load_solver_state(path, {"mu": torch.zeros(50)})


@pytest.mark.parametrize("stop", ["early-stop", "nan", "budget", "budget-grown"])
def test_finality_guard(tmp_path, stop):
    img, mask = _problem((24, 16))
    kw = dict(epochs=40, scan_chunk=5)
    if stop == "early-stop":  # a 50 % min-delta is unmeetable: stops at 4
        kw.update(earlystop_patience=3, earlystop_min_delta=50.0)
    if stop == "nan":
        img[3, 2, 0] = np.nan
    if stop.startswith("budget"):
        kw.update(epochs=10)
    cfg = _cfg("2d", **kw)
    ckpt = str(tmp_path / "s.npz")
    first = DIPSolver(cfg, device="cpu").solve(img, mask, seed=0, checkpoint_path=ckpt,
                                               checkpoint_every=1)
    more = 20 if stop == "budget-grown" or not stop.startswith("budget") else 10
    again = DIPSolver(Config(**{**cfg.to_dict(), "epochs": more}), device="cpu").solve(
        img, mask, seed=0, checkpoint_path=ckpt, checkpoint_every=1)
    if stop == "budget-grown":  # reopened: 10 more iterations
        assert first.iters_run == 10 and again.iters_run == 20
        assert len(again.history.loss) == 20 and not again.stopped_early
        return
    # final: not one step more, the same result
    assert again.chunk_seconds == [] and again.iters_run == first.iters_run
    assert again.stopped_early == (stop != "budget")
    np.testing.assert_array_equal(again.out_best, first.out_best)
    np.testing.assert_array_equal(again.history.loss, first.history.loss)
    if stop == "nan":
        assert first.iters_run == 1 and np.isnan(first.history.loss[-1])


def test_npz_path():
    assert npz_path("a/b") == "a/b.npz"
    assert npz_path("a/b.npz") == "a/b.npz"
    assert npz_path("a/b.ckpt") == "a/b.ckpt.npz"


def test_weights_files_and_the_config_gate(tmp_path):
    cfg = _cfg("2d")
    model = DIPSolver(cfg, device="cpu").model
    init_weights(model, torch.Generator().manual_seed(0))
    run = tmp_path / "run"
    write_args(str(run / "args.txt"), cfg)
    save_params(str(run / "0_model.pt"), model.state_dict())
    template = model.state_dict()
    back = load_checked("run/0_model.pt", cfg, template, str(tmp_path))
    assert set(back) == set(template)
    assert all(torch.equal(back[k], template[k]) for k in template)
    with pytest.raises(ValueError, match="incompatible"):
        load_checked("run/0_model.pt", Config(**{**cfg.to_dict(), "inputdepth": 8}),
                     template, str(tmp_path))
    with pytest.raises(KeyError):
        load_params(str(run / "0_model.pt"), {"other": torch.zeros(1)})
    # the JAX package's weights file of the same net: read through the bridge,
    # every leaf equal, and checked against the template like a .pt
    from flax import serialization
    (run / "0_model.msgpack").write_bytes(
        serialization.to_bytes(state_dict_to_jax_params(model.state_dict())))
    back = load_checked("run/0_model.msgpack", cfg, template, str(tmp_path))
    assert all(torch.equal(back[k], template[k]) for k in template)
    with pytest.raises(KeyError):
        load_params(str(run / "0_model.msgpack"), {"other": torch.zeros(1)})


def test_snapshots_match_jax():
    img, mask = _problem((24, 16))
    kw = dict(datadim="2d", epochs=9, scan_chunk=9, save_every=3, inputdepth=4,
              filters=[8, 16], skip=[4], reg_noise_std=0.0, gain=1.0)
    port = DIPSolver(Config(**kw), device="cpu")
    init_weights(port.model, torch.Generator().manual_seed(0), "xavier", 0.02)
    init = {k: v.clone() for k, v in port.model.state_dict().items()}
    ref = JaxDIPSolver(JaxConfig(**kw), outchannel=1).solve(
        img, mask, seed=0, init_params=state_dict_to_jax_params(init))
    got = port.solve(img, mask, seed=0, init_params=init, noise=ref.noise)
    assert sorted(got.snapshots) == sorted(ref.snapshots) == [3, 6]
    for it, snap in got.snapshots.items():
        assert snap.dtype == np.float32 and snap.shape == img.shape
        np.testing.assert_allclose(snap, ref.snapshots[it], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got.history.loss, ref.history.loss, rtol=2e-4)
