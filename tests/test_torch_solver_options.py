"""The solver options of the port: input optimisation, data forgetting and
canvas shaping against the JAX package's solver; remat, the virtual canvas,
dropout and parameter noise, whose random streams the two packages cannot
share, against the port itself; and an exact resume with each option on."""
import numpy as np
import pytest
import torch

import jax
from deep_prior_interpolation_tpu.config import Config as JaxConfig
from deep_prior_interpolation_tpu.engine import DIPSolver as JaxDIPSolver
from deep_prior_interpolation_tpu.engine import build_base_input as jax_build_base_input
from deep_prior_interpolation_tpu_torch import Config, DIPSolver
from deep_prior_interpolation_tpu_torch.engine.solver import _FlatParams
from deep_prior_interpolation_tpu_torch.io import state_dict_to_jax_params
from deep_prior_interpolation_tpu_torch.models import (Dropout, MulResUnet, init_weights,
                                                       set_dropout_generator)

torch.set_num_threads(1)


def problem(nt=16, nx=16):
    rng = np.random.RandomState(0)
    t = np.linspace(0, 1, nt)[:, None]
    x = np.linspace(0, 1, nx)[None, :]
    img = np.sin(2 * np.pi * (3 * t + 2 * x)).astype(np.float32)[..., None]
    mask = np.repeat((rng.rand(1, nx) > 0.5).astype(np.float32), nt, 0)[..., None]
    return img, mask


def tiny(**kw):
    base = dict(datadim="2d", epochs=4, inputdepth=4, filters=[4, 8], skip=[4],
                scan_chunk=2, gain=1.0)
    base.update(kw)
    return Config(**base)


def test_options_solve_matches_jax():
    """Input optimisation, data forgetting and the low-pass canvas together,
    3 steps, float32, no step noise: the same canvas and weights in both."""
    img, mask = problem()
    kw = dict(datadim="2d", epochs=3, scan_chunk=3, inputdepth=4, filters=[4, 8], skip=[4],
              gain=1.0, reg_noise_std=0.0, opt_over="net,input", data_forgetting_factor=2,
              lowpass_fs=250.0, lowpass_fc=40.0)
    port = DIPSolver(Config(**kw), device="cpu")
    init_weights(port.model, torch.Generator().manual_seed(0), "xavier", 0.02)
    init = {k: v.clone() for k, v in port.model.state_dict().items()}
    jcfg = JaxConfig(**kw)
    ref = JaxDIPSolver(jcfg, outchannel=1).solve(img, mask, seed=0,
                                                 init_params=state_dict_to_jax_params(init))
    # the JAX solve's shaped canvas: its first key, as DIPSolver.solve splits it
    k_noise = jax.random.split(jax.random.PRNGKey(0), 3)[0]
    canvas = np.asarray(jax_build_base_input(jcfg, k_noise, (16, 16)))[0]
    got = port.solve(img, mask, seed=0, init_params=init, noise=canvas)
    np.testing.assert_allclose(got.history.loss, ref.history.loss, rtol=2e-4)
    np.testing.assert_allclose(got.history.snr, ref.history.snr, rtol=1e-3, atol=1e-3)
    # the optimised canvas: 3 Adam steps of lr 1e-3 from the same start
    moved = np.abs(ref.noise - canvas).max()
    assert moved > 1e-4
    np.testing.assert_allclose(got.noise, ref.noise, rtol=0, atol=1e-2 * moved)
    assert set(got.params) == set(init)  # the net's parameters only


@pytest.mark.parametrize("remat_levels", [None, 1])
def test_remat_gradients_bit_equal_with_dropout(remat_levels):
    def grads(remat):
        m = MulResUnet(4, 1, 3, (4, 8, 8), (4, 4), dropout=0.2, remat=remat,
                       remat_levels=remat_levels)
        init_weights(m, torch.Generator().manual_seed(0))
        set_dropout_generator(m, torch.Generator().manual_seed(5))
        x = torch.from_numpy(np.random.RandomState(1).randn(1, 4, 8, 8, 8).astype(np.float32))
        out = m(x)
        g = torch.autograd.grad((out * out).sum(), list(m.parameters()))
        return out, g
    (o1, g1), (o2, g2) = grads(False), grads(True)
    assert torch.equal(o1, o2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_remat_solve_bit_equal_with_dropout():
    img, mask = problem()
    a = DIPSolver(tiny(dropout=0.1), device="cpu").solve(img, mask, seed=3)
    b = DIPSolver(tiny(dropout=0.1, remat=True), device="cpu").solve(img, mask, seed=3)
    assert a.history.loss == b.history.loss
    np.testing.assert_array_equal(a.out_best, b.out_best)


def test_virtual_input_is_bit_equal_to_the_stored_canvas():
    img, mask = problem()
    a = DIPSolver(tiny(), device="cpu").solve(img, mask, seed=1)
    b = DIPSolver(tiny(virtual_input=True), device="cpu").solve(img, mask, seed=1)
    assert a.history.loss == b.history.loss and a.history.snr == b.history.snr
    np.testing.assert_array_equal(a.noise, b.noise)
    np.testing.assert_array_equal(a.out_best, b.out_best)


def test_dropout_keeps_its_fraction_at_its_exact_scale():
    d = Dropout(0.25)
    x = torch.from_numpy(np.random.RandomState(2).randn(200_000).astype(np.float32))
    with pytest.raises(RuntimeError, match="generator"):
        d(x)
    d.generator = torch.Generator().manual_seed(0)
    y = d(x)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.005
    torch.testing.assert_close(y[kept], x[kept] / 0.75, rtol=0, atol=0)
    d.generator = torch.Generator().manual_seed(0)
    assert torch.equal(d(x), y)  # the same generator state, the same mask
    assert torch.equal(Dropout(0.0)(x), x)


def test_param_noise_touches_only_conv_kernels_with_population_std():
    m = MulResUnet(4, 1, 2, (4, 8), (4,))
    init_weights(m, torch.Generator().manual_seed(0))
    flat = _FlatParams(m)
    shapes = [(p.ndim, p.numel()) for p in flat.params]
    before = flat.perturb(torch.Generator().manual_seed(7))
    delta = flat.flat - before
    # the same draw by hand: one N(0, 1) per kernel element, times 0.02 times
    # each kernel's population std
    noise = torch.randn(int(flat._kernel_idx.numel()), generator=torch.Generator().manual_seed(7))
    off, k = 0, 0
    for nd, n in shapes:
        seg = delta[off:off + n]
        if nd >= 4:
            std = before[off:off + n].std(correction=0)
            assert std != before[off:off + n].std()  # ddof 0, not torch's default 1
            want = before[off:off + n] + noise[k:k + n] * std * 0.02
            torch.testing.assert_close(flat.flat[off:off + n], want, rtol=0, atol=0)
            k += n
        else:
            assert torch.all(seg == 0)
        off += n


def test_param_noise_persists_into_the_update_and_is_frozen_when_done():
    m = MulResUnet(4, 1, 2, (4, 8), (4,))
    init_weights(m, torch.Generator().manual_seed(0))
    flat = _FlatParams(m)
    lr = torch.tensor(1e-3)
    before = flat.perturb(torch.Generator().manual_seed(1))
    perturbed = flat.flat.clone()
    grads = [torch.ones_like(p) for p in flat.params]
    flat.adam_step(grads, lr, torch.tensor(False), before)
    # the first Adam step of a gradient of ones is 1: p_perturbed - lr
    torch.testing.assert_close(flat.flat, perturbed - lr, rtol=0, atol=1e-7)
    assert not torch.allclose(flat.flat, before - lr)
    again = flat.flat.clone()
    unperturbed = again.clone()
    flat.perturb(torch.Generator().manual_seed(2))
    flat.adam_step(grads, lr, torch.tensor(True), unperturbed)
    assert torch.equal(flat.flat, unperturbed) and int(flat.count) == 1


@pytest.mark.parametrize("kw", [
    dict(param_noise=True), dict(dropout=0.1, remat=True), dict(opt_over="net,input"),
    dict(data_forgetting_factor=3, lowpass_fs=250.0, lowpass_fc=40.0),
    dict(virtual_input=True), dict(net="part"),
], ids=["param_noise", "dropout_remat", "opt_input", "forgetting_lowpass", "virtual", "part"])
def test_resume_is_bit_exact_with_each_option(kw, tmp_path):
    img, mask = problem(32, 32)
    cfg = tiny(epochs=6, **kw)
    straight = DIPSolver(cfg, device="cpu").solve(img, mask, seed=2)
    path = str(tmp_path / "state")
    DIPSolver(Config(**{**cfg.to_dict(), "epochs": 2}), device="cpu").solve(
        img, mask, seed=2, checkpoint_path=path, checkpoint_every=1)
    resumed = DIPSolver(cfg, device="cpu").solve(img, mask, seed=2, checkpoint_path=path)
    assert resumed.history.loss == straight.history.loss
    np.testing.assert_array_equal(resumed.out_best, straight.out_best)
    np.testing.assert_array_equal(resumed.noise, straight.noise)


def test_bfloat16_refusals_match_the_jax_package():
    """The JAX package's scan refuses these with TypeError (its carry would
    change dtype): a bfloat16 canvas under optimisation, and a float32 net
    output against the bfloat16 tracked output."""
    img, mask = problem()
    for kw in (dict(opt_over="net,input"), dict(data_forgetting_factor=3)):
        with pytest.raises(TypeError):
            DIPSolver(tiny(dtype="bfloat16", **kw), device="cpu").solve(img, mask)
