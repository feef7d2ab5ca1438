"""The port's DIPSolver (engine/solver.py) against the JAX package's solver on a
small 3D problem, and its plateau-LR / early-stop / refusal behaviour alone.

JAX and torch draw different random numbers, so the JAX run's noise canvas
and the same initial parameters (drawn by the port, bridged to JAX) go into
both solves, with no per-step input noise (reg_noise_std=0)."""
import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu.config import Config as JaxConfig
from deep_prior_interpolation_tpu.engine import DIPSolver as JaxDIPSolver
from deep_prior_interpolation_tpu_torch import Config, DIPSolver
from deep_prior_interpolation_tpu_torch.data import flagship_problem
from deep_prior_interpolation_tpu_torch.io import state_dict_to_jax_params
from deep_prior_interpolation_tpu_torch.models import init_weights

torch.set_num_threads(1)

SMALL = dict(datadim="3d", epochs=6, scan_chunk=3, inputdepth=4, filters=[4, 8],
             skip=[4], reg_noise_std=0.0, fused_loss=True)


def test_3d_solve_matches_jax():
    img, mask = flagship_problem(8, 16, 16)
    port = DIPSolver(Config(**SMALL), device="cpu")
    init_weights(port.model, torch.Generator().manual_seed(0), "xavier", 0.02)
    init = {k: v.clone() for k, v in port.model.state_dict().items()}
    ref = JaxDIPSolver(JaxConfig(**SMALL), outchannel=1).solve(
        img, mask, seed=0, init_params=state_dict_to_jax_params(init))
    got = port.solve(img, mask, seed=0, init_params=init, noise=ref.noise)

    assert got.iters_run == ref.iters_run == 6
    assert got.out_best.shape == ref.out_best.shape == img.shape
    np.testing.assert_allclose(got.history.lr, ref.history.lr, rtol=1e-7)
    # tolerances of tests/test_pallas.py's fused-vs-plain trajectory test
    np.testing.assert_allclose(got.history.loss, ref.history.loss, rtol=2e-4)
    np.testing.assert_allclose(got.history.snr, ref.history.snr, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.history.pcorr, ref.history.pcorr, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.out_best, ref.out_best, rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(got.noise, ref.noise)


# --- the port alone (mirrors tests/test_engine.py) ---------------------

def tiny_cfg(**kw):
    base = dict(datadim="2d", epochs=40, inputdepth=4, filters=[8, 16], skip=[4],
                scan_chunk=10, reg_noise_std=0.03, gain=1.0)
    base.update(kw)
    return Config(**base)


def synth_problem(nt=32, nx=24, drop=0.5):
    rng = np.random.RandomState(0)
    t = np.linspace(0, 1, nt)[:, None]
    x = np.linspace(0, 1, nx)[None, :]
    img = np.sin(2 * np.pi * (3 * t + 2 * x)).astype(np.float32)[..., None]
    m = (rng.rand(1, nx) > drop).astype(np.float32)
    return img, np.repeat(m, nt, 0)[..., None]


def test_early_stopping_triggers():
    img, mask = synth_problem()
    # patience 3 with a 50 % min-delta is unmeetable -> stops early
    cfg = tiny_cfg(epochs=40, earlystop_patience=3, earlystop_min_delta=50.0)
    res = DIPSolver(cfg, device="cpu").solve(img, mask, seed=0)
    assert res.stopped_early
    assert res.iters_run == len(res.history.loss) == 4  # it 0 sets the best, 1..3 are bad


def test_reduce_lr_plateau():
    img, mask = synth_problem()
    cfg = tiny_cfg(epochs=12, scan_chunk=4, reduce_lr=True, lr_patience=2,
                   lr_factor=0.5, lr_thresh=0.9)  # near-impossible rel improvement
    res = DIPSolver(cfg, device="cpu").solve(img, mask, seed=0)
    lrs = np.asarray(res.history.lr)
    assert lrs[0] == pytest.approx(cfg.lr)
    # the first loss is the best; then every 3rd bad step cuts the lr
    np.testing.assert_allclose(lrs[:4], [cfg.lr] * 4, rtol=1e-6)
    assert lrs[-1] < lrs[0]
    assert np.all(np.diff(lrs) <= 0)


def test_fused_loss_matches_plain_loss_in_the_port():
    img, mask = synth_problem()

    def solve(fused):
        cfg = tiny_cfg(epochs=10, scan_chunk=5, fused_loss=fused)
        return DIPSolver(cfg, device="cpu").solve(img, mask, seed=0)
    a, b = solve(False), solve(True)
    np.testing.assert_allclose(a.history.loss, b.history.loss, rtol=2e-4)
    np.testing.assert_allclose(a.history.snr, b.history.snr, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(a.out_best, b.out_best, rtol=1e-3, atol=1e-4)


def test_best_output_and_history_shapes():
    img, mask = synth_problem()
    res = DIPSolver(tiny_cfg(epochs=7, scan_chunk=3), device="cpu").solve(img, mask)
    assert res.iters_run == 7 and len(res.history.loss) == 7
    assert len(res.chunk_seconds) == 3
    assert res.out_best.shape == img.shape and res.noise.shape == img.shape[:-1] + (4,)
    assert np.all(np.isfinite(res.out_best))
