"""The port's SkipNet and UNet against the JAX package's flax modules, with
the parameters drawn by the port and bridged to JAX (io/bridge.py): names,
forward, gradients, the bridge both ways, the factory, and one solve."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deep_prior_interpolation_tpu.models as J
from deep_prior_interpolation_tpu.config import Config as JaxConfig
from deep_prior_interpolation_tpu.engine import DIPSolver as JaxDIPSolver
from deep_prior_interpolation_tpu_torch import Config, DIPSolver
from deep_prior_interpolation_tpu_torch import models as P
from deep_prior_interpolation_tpu_torch.io import (jax_params_to_state_dict,
                                                   state_dict_to_jax_params)

torch.set_num_threads(1)


def _cf(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _cl(t):
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


def run_pair(jm, tm, x, seed=0):
    """(jax out, port out, jax grads as a state dict, port grads) of
    sum(out * cot), the port's weights bridged into the JAX module."""
    P.init_weights(tm, torch.Generator().manual_seed(seed), "xavier", 0.02)
    params = state_dict_to_jax_params(tm.state_dict())
    shape = jax.eval_shape(lambda p: jm.apply({"params": p}, jnp.asarray(x)), params).shape
    cot = np.random.RandomState(seed + 1).randn(*shape).astype(np.float32)

    def f(p):
        out = jm.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(out * cot), out
    jg, jout = jax.jit(jax.grad(f, has_aux=True))(params)
    jg = jax_params_to_state_dict(jax.device_get(jg), like=tm.state_dict())
    tout = tm(_cf(x))
    (tout.float() * _cf(cot)).sum().backward()
    return np.asarray(jout, np.float32), _cl(tout), jg, {n: p.grad for n, p in tm.named_parameters()}


def check_pair(jout, tout, jg, tg):
    """Forward to 1e-5 of its largest value; every gradient to 1e-4 of its
    own largest entry plus 1e-6 of the largest gradient, the rounding floor
    of conv biases that feed a Norm (zero up to rounding in both)."""
    assert tout.shape == jout.shape
    np.testing.assert_allclose(tout, jout, rtol=0, atol=1e-5 * np.abs(jout).max())
    assert set(jg) == set(tg)
    g_max = max(float(g.abs().max()) for g in jg.values())
    for name, g in tg.items():
        ref = jg[name].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max() + 1e-6 * g_max, err_msg=name)


def _x(*shape, seed=3):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


SKIPS = {
    "2d": (dict(ndim=2, filters=(8, 16), skip=(4, 4)), (1, 16, 16, 4)),
    "3d_reflection": (dict(ndim=3, filters=(4, 8), skip=(4, 4), pad="reflection",
                           upsample_mode="trilinear"), (1, 8, 8, 8, 4)),
    "2d_no_skip_no_1x1": (dict(ndim=2, filters=(8, 8), skip=(0, 4), need1x1_up=False,
                               upsample_mode="bilinear"), (1, 16, 16, 4)),
}


@pytest.mark.parametrize("case", sorted(SKIPS))
def test_skipnet_matches_jax(case):
    kw, shape = SKIPS[case]
    check_pair(*run_pair(J.SkipNet(out_channels=1, **kw), P.SkipNet(shape[-1], 1, **kw),
                         _x(*shape)))


@pytest.mark.parametrize("mode", ["avg", "max", "lanczos2"])
def test_skipnet_downsample_modes_match_jax(mode):
    kw = dict(ndim=2, filters=(8, 8), skip=(4, 4), downsample_mode=mode)
    check_pair(*run_pair(J.SkipNet(out_channels=1, **kw), P.SkipNet(2, 1, **kw),
                         _x(1, 16, 16, 2)))


UNETS = {
    "2d_deconv": (dict(ndim=2, filters=(4, 8, 8, 8, 8), upsample_mode="deconv"), (1, 32, 32, 4)),
    "2d_concat_x_more_layers": (dict(ndim=2, filters=(6, 8, 8, 8, 8), concat_x=True,
                                     more_layers=1), (1, 64, 64, 4)),
    "3d_trilinear": (dict(ndim=3, filters=(4, 4, 4, 4, 4), upsample_mode="trilinear"),
                     (1, 16, 16, 16, 4)),
}


@pytest.mark.parametrize("case", sorted(UNETS))
def test_unet_matches_jax(case):
    kw, shape = UNETS[case]
    kw = dict(kw, act="LeakyReLU")
    check_pair(*run_pair(J.UNet(out_channels=1, **kw), P.UNet(shape[-1], 1, **kw), _x(*shape)))


def test_instance_norm_matches_jax():
    x = (2.0 + 3.0 * _x(2, 6, 5, 4, 3)).astype(np.float32)
    want = np.asarray(J.InstanceNorm().apply({}, jnp.asarray(x)))
    np.testing.assert_allclose(_cl(P.InstanceNorm()(_cf(x))), want, rtol=1e-5, atol=1e-5)
    wb = np.asarray(J.InstanceNorm().apply({}, jnp.asarray(x).astype(jnp.bfloat16)), np.float32)
    got = P.InstanceNorm()(_cf(x).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_cl(got), wb, rtol=0, atol=0.05)


NETS = {"skip_3d": lambda: (J.SkipNet(out_channels=1, ndim=3, filters=(4, 8), skip=(4, 4)),
                            P.SkipNet(4, 1, 3, (4, 8), (4, 4)), (1, 8, 8, 8, 4)),
        "unet_deconv": lambda: (J.UNet(out_channels=1, ndim=2, filters=(4, 8, 8, 8, 8),
                                       upsample_mode="deconv"),
                                P.UNet(4, 1, 2, (4, 8, 8, 8, 8), upsample_mode="deconv"),
                                (1, 32, 32, 4))}


@pytest.mark.parametrize("name", sorted(NETS))
def test_bridge_round_trips_with_flax_names(name):
    jm, tm, shape = NETS[name]()
    tree = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros(shape))["params"]
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), tree)
    jax_params_to_state_dict(zeros, like=tm.state_dict())  # every leaf, every shape
    P.init_weights(tm, torch.Generator().manual_seed(1), "normal", 1.0)
    there = state_dict_to_jax_params(tm.state_dict(), like=zeros)
    back = jax_params_to_state_dict(there, like=tm.state_dict())
    for k, v in tm.state_dict().items():
        assert torch.equal(back[k], v), k
    again = state_dict_to_jax_params(back, like=zeros)
    for path, leaf in jax.tree_util.tree_leaves_with_path(there):
        np.testing.assert_array_equal(dict(jax.tree_util.tree_leaves_with_path(again))[path],
                                      leaf)


def test_default_init_draws_flax_initialisers():
    m = P.UNet(4, 1, 2, (4, 8, 8, 8, 8), upsample_mode="deconv")
    P.init_weights(m, torch.Generator().manual_seed(0), "default")
    k = m.ConvTranspose_0.kernel.detach()  # (in, out, 4, 4): lecun normal, fan_in = in x 16
    std = np.sqrt(1.0 / (k.shape[0] * 16))
    assert abs(float(k.std()) / std - 1) < 0.1 and float(k.abs().max()) <= 2 * std / 0.8796 + 1e-6
    assert all(torch.all(p == 0) for n, p in m.named_parameters() if n.endswith("bias"))


def test_factory_builds_skip_and_unet():
    cfg = Config(datadim="3d", net="skip", filters=[4, 8], skip=[4], inputdepth=4)
    assert isinstance(P.get_net(cfg, 1), P.SkipNet)
    cfg = Config(datadim="2d", net="unet", filters=[4, 8, 8, 8, 8], skip=[4, 4, 4, 4],
                 inputdepth=4, upsample="linear")
    net = P.get_net(cfg, 1)
    assert isinstance(net, P.UNet) and net.upsample_mode == "bilinear"
    with pytest.raises(ValueError, match="unknown net"):
        P.get_net(Config(net="nope"), 1)


def test_skipnet_solve_matches_jax():
    vol = np.sin(np.linspace(0, 6, 8))[:, None, None] * np.cos(np.linspace(0, 3, 16))[None, :, None]
    img = (vol * np.ones((8, 16, 16)))[..., None].astype(np.float32)
    mask = np.repeat((np.random.RandomState(0).rand(1, 16, 16) > 0.5), 8, 0)[..., None]
    mask = mask.astype(np.float32)
    kw = dict(datadim="3d", net="skip", epochs=3, scan_chunk=3, inputdepth=4, filters=[4, 8],
              skip=[4], reg_noise_std=0.0, upsample="linear")
    port = DIPSolver(Config(**kw), device="cpu")
    P.init_weights(port.model, torch.Generator().manual_seed(0), "xavier", 0.02)
    init = {k: v.clone() for k, v in port.model.state_dict().items()}
    ref = JaxDIPSolver(JaxConfig(**kw), outchannel=1).solve(
        img, mask, seed=0, init_params=state_dict_to_jax_params(init))
    got = port.solve(img, mask, seed=0, init_params=init, noise=ref.noise)
    np.testing.assert_allclose(got.history.loss, ref.history.loss, rtol=2e-4)
    np.testing.assert_allclose(got.history.snr, ref.history.snr, rtol=1e-3, atol=1e-3)
