"""The port's POCS projection (ops/pocs.py) and the solver's POCS term
against the JAX package.

The projections take the same float32 inputs in both layouts (the JAX
package is channels-last, the port channels-first) and agree to 1e-5 of the
largest value: the FFTs of the two libraries round differently. The tiny
DIP+POCS solve gets the JAX run's canvas and the same initial weights
(through io/bridge.py) with no per-step input noise, and is held at
tests/test_torch_solver.py's tolerances."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from deep_prior_interpolation_tpu.config import Config as JaxConfig
from deep_prior_interpolation_tpu.engine import DIPSolver as JaxDIPSolver
from deep_prior_interpolation_tpu.ops import pocs as J
from deep_prior_interpolation_tpu_torch import Config, DIPSolver
from deep_prior_interpolation_tpu_torch.engine.solver import StepSettings, build_hyper, pocs_term
from deep_prior_interpolation_tpu_torch.io import state_dict_to_jax_params
from deep_prior_interpolation_tpu_torch.models import init_weights
from deep_prior_interpolation_tpu_torch.ops import losses as L
from deep_prior_interpolation_tpu_torch.ops import pocs as P

torch.set_num_threads(1)


def _problem(spatial, seed=0):
    """Channels-last (1, *spatial, 1) arrays: a decimated plane-wave image,
    its trace mask and a noisy 'output'."""
    rng = np.random.RandomState(seed)
    grids = np.meshgrid(*[np.linspace(0, 1, n) for n in spatial], indexing="ij")
    img = np.sin(2 * np.pi * sum((k + 2) * g for k, g in enumerate(grids)))
    mask = np.repeat(rng.rand(1, *spatial[1:]) > 0.4, spatial[0], 0)
    out = img + 0.3 * rng.randn(*spatial)
    return [a[None, ..., None].astype(np.float32) for a in (out, img, mask)]


def _cf(a):
    """Channels-last numpy -> channels-first tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _cl(t):
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


def _close(got, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("spatial,dtype", [((24, 16), "float32"), ((8, 12, 10), "float32"),
                                           ((24, 16), "bfloat16")])
def test_fk_projection_matches_jax(spatial, dtype):
    x, img, mask = _problem(spatial)
    wd, wm = 0.1 * img * mask, 1.0 - 0.1 * mask
    jx = jnp.asarray(x).astype(dtype)
    want, th_want = J.fk_projection(jx, jnp.asarray(wd), jnp.asarray(wm), 5.0,
                                    return_threshold=True)
    px = _cf(x).to(getattr(torch, dtype))
    got, th = P.fk_projection(px, _cf(wd), _cf(wm), 5.0, return_threshold=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(th), float(th_want), rtol=1e-5)
    # bf16: the projection rounds to bf16, where an FFT's last-bit difference
    # may move a value by one bf16 ulp (2^-8 of its size)
    _close(_cl(got), want, 1e-5 if dtype == "float32" else 2.0 ** -8)


@pytest.mark.parametrize("spatial", [(24, 16), (8, 12, 10)])
def test_pocs_fk_fn_and_pocs_operator_match_jax(spatial):
    x, img, mask = _problem(spatial, seed=1)
    th = 0.05 * float(np.abs(np.fft.fftn(x[0, ..., 0])).max())
    _close(P.pocs_fk_fn(_cf(x), _cf(img), _cf(mask), th, 0.2).numpy(),
           J.pocs_fk_fn(jnp.asarray(np.moveaxis(x, -1, 1)), jnp.asarray(np.moveaxis(img, -1, 1)),
                        jnp.asarray(np.moveaxis(mask, -1, 1)), th, 0.2))
    for perc, thresh in ((7.0, None), (None, th)):
        want = J.POCS(jnp.asarray(img), jnp.asarray(mask), 0.3, thresh_perc=perc)(
            jnp.asarray(x), thresh)
        got = P.POCS(_cf(img), _cf(mask), 0.3, thresh_perc=perc)(_cf(x), thresh)
        _close(_cl(got), want)


def test_threshold_is_per_component_not_magnitude():
    z = torch.tensor([[3.0 + 3.0j, 0.5 + 4.9j, 4.0 + 0.0j]])
    np.testing.assert_array_equal(P.threshold(z, 4.5).numpy(),
                                  np.array([[0.0, 4.9j, 0.0]], np.complex64))
    assert float(P.compute_threshold(z, 10.0)) == pytest.approx(0.49)


TINY = dict(datadim="2d", epochs=6, scan_chunk=3, inputdepth=4, filters=[8, 16], skip=[4],
            reg_noise_std=0.0, gain=1.0, pocs=True, pocs_alpha=0.2, pocs_thresh=5.0)


def test_pocs_solve_matches_jax():
    # the JAX solve with the plain loss (its fused kernel in interpret mode
    # compiles for a minute); the port's with the plain loss and with the
    # fused loss, whose main term is the same function
    _, img, mask = _problem((24, 16))
    img, mask = img[0], mask[0]
    port = DIPSolver(Config(**TINY), device="cpu")
    init_weights(port.model, torch.Generator().manual_seed(0), "xavier", 0.02)
    init = {k: v.clone() for k, v in port.model.state_dict().items()}
    ref = JaxDIPSolver(JaxConfig(**TINY), outchannel=1).solve(
        img, mask, seed=0, init_params=state_dict_to_jax_params(init))
    for fused in (False, True):
        got = DIPSolver(Config(**TINY, fused_loss=fused), device="cpu").solve(
            img, mask, seed=0, init_params=init, noise=ref.noise)
        assert got.iters_run == ref.iters_run == 6
        assert type(got.history).FIELDS == type(ref.history).FIELDS
        for f in ("loss", "df"):
            np.testing.assert_allclose(getattr(got.history, f), getattr(ref.history, f),
                                       rtol=2e-4)
        for f in ("reg", "eps", "th", "snr", "pcorr"):
            np.testing.assert_allclose(getattr(got.history, f), getattr(ref.history, f),
                                       rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(got.out_best, ref.out_best, rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(got.pocs, ref.pocs, rtol=1e-3, atol=1e-4)


def _term(**kw):
    cfg = Config(**{**TINY, **kw})
    _, img, mask = _problem((24, 16), seed=2)
    out = _cf(img + 0.5 * np.random.RandomState(3).randn(*img.shape).astype(np.float32))
    out.requires_grad_(True)
    img_t, mask_t = _cf(img), _cf(mask)
    data = {"pocs_wdata": 0.2 * img_t * mask_t, "pocs_wmask": 1.0 - 0.2 * mask_t}
    main = L.masked_mae(out, img_t, mask_t)
    total, reg, eps, th = pocs_term(out, main, data, build_hyper(cfg, "cpu"),
                                    StepSettings.from_config(cfg, (24, 16)))
    g_total, = torch.autograd.grad(total, out, retain_graph=True)
    g_main, = torch.autograd.grad(main, out)
    return g_total, g_main, eps


def test_attached_eps_doubles_the_main_gradient():
    # eps = main / reg attached: eps * reg equals main as a function
    g_total, g_main, _ = _term(pocs_eps_mode="attached")
    torch.testing.assert_close(g_total, 2.0 * g_main, rtol=1e-5, atol=1e-9)
    g_total, g_main, _ = _term()  # detached: the regulariser pulls toward proj
    assert not torch.allclose(g_total, 2.0 * g_main)


def test_fixed_pocs_weight_is_recorded_as_eps():
    _, _, eps = _term(pocs_weight=0.5)
    assert float(eps) == 0.5
    _, img, mask = _problem((24, 16))
    res = DIPSolver(Config(**{**TINY, "pocs_weight": 0.5, "epochs": 4}),
                    device="cpu").solve(img[0], mask[0], seed=0)
    assert res.history.eps == [0.5] * 4
    assert np.all(np.isfinite(res.history.reg)) and res.pocs.shape == img[0].shape
