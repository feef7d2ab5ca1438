"""The port's phase-space MulResUnet against the JAX package's phase net
(the parameters drawn by the port and bridged, io/bridge.py) and against
its own plain net, at JAX's cases (tests/test_phase_space.py): the output
and every parameter gradient.

Tolerances are JAX's own for its phase net against its plain net: the
output to 2e-5 of its largest value, each gradient to 5e-5 of the largest
gradient (a conv bias that feeds a Norm has a zero gradient up to rounding,
so a gradient's own scale is no yardstick); bf16 to 0.05 of the output."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu.models import MulResUnet as JaxMulResUnet
from deep_prior_interpolation_tpu_torch import Config
from deep_prior_interpolation_tpu_torch.io import (jax_params_to_state_dict,
                                                   state_dict_to_jax_params)
from deep_prior_interpolation_tpu_torch.models import MulResUnet, get_net, init_weights
from deep_prior_interpolation_tpu_torch.ops import conv_vjp

torch.set_num_threads(1)

IN_CH = 6
OUT_TOL, GRAD_TOL = 2e-5, 5e-5
# JAX's cases: (ndim, spatial, phase_levels, phase_deep_levels)
CASES = [(3, (16, 8, 8), 2, 0), (3, (16, 16, 8), None, 0), (2, (16, 8), 2, 0),
         (3, (16, 8, 8), 2, 1), (2, (16, 8), 2, 1), (3, (16, 16, 8), 2, 2)]


def _kw(ndim):
    return dict(out_channels=1, ndim=ndim, filters=(4, 8, 16), skip=(4, 8),
                upsample_mode="trilinear" if ndim == 3 else "bilinear")


def _nets(ndim, levels, deep, dtype=None, remat=False):
    """(plain, phase) port nets with the same parameters."""
    plain = MulResUnet(IN_CH, **_kw(ndim), dtype=dtype, remat=remat)
    init_weights(plain, torch.Generator().manual_seed(0), "xavier", 0.02)
    phase = MulResUnet(IN_CH, **_kw(ndim), dtype=dtype, remat=remat, phase_space=True,
                       phase_levels=levels, phase_deep_levels=deep)
    phase.load_state_dict(plain.state_dict(), strict=True)
    return plain, phase


def _input(ndim, sp):
    x = np.random.RandomState(1234 + ndim).randn(1, IN_CH, *sp).astype(np.float32)
    return torch.from_numpy(x)


def _out_and_grads(net, x):
    net.zero_grad()
    out = net(x)
    (out.float() ** 2).mean().backward()
    return out.detach().float(), {n: p.grad.clone() for n, p in net.named_parameters()}


def _assert_close(out, grads, ref_out, ref_grads):
    scale = float(ref_out.abs().max())
    np.testing.assert_allclose(out.numpy() / scale, ref_out.numpy() / scale, atol=OUT_TOL)
    assert set(grads) == set(ref_grads)
    gs = max(float(g.abs().max()) for g in ref_grads.values())
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy() / gs, ref_grads[name].numpy() / gs,
                                   atol=GRAD_TOL, err_msg=name)


@functools.lru_cache(maxsize=None)
def _jax_case(ndim, sp, levels, deep):
    """The JAX phase net's output and gradients at the port's parameters."""
    plain, _ = _nets(ndim, levels, deep)
    params = state_dict_to_jax_params(plain.state_dict())
    jm = JaxMulResUnet(**_kw(ndim), phase_space=True, phase_levels=levels,
                       phase_deep_levels=deep)
    xj = jnp.asarray(np.moveaxis(_input(ndim, sp).numpy(), 1, -1))

    def loss(p):
        out = jm.apply({"params": p}, xj)
        return jnp.mean(out ** 2), out
    g, out = jax.jit(jax.grad(loss, has_aux=True))(params)
    grads = jax_params_to_state_dict(jax.device_get(g), like=plain.state_dict())
    return torch.from_numpy(np.moveaxis(np.array(out), -1, 1)), grads


@pytest.mark.parametrize("case", [CASES[1], CASES[4], CASES[5]])
def test_phase_net_matches_the_jax_phase_net(case):
    ndim, sp, levels, deep = case
    _, phase = _nets(ndim, levels, deep)
    out, grads = _out_and_grads(phase, _input(ndim, sp))
    _assert_close(out, grads, *_jax_case(ndim, sp, levels, deep))


@pytest.mark.parametrize("case", CASES)
def test_phase_net_matches_the_plain_net(case):
    ndim, sp, levels, deep = case
    plain, phase = _nets(ndim, levels, deep)
    x = _input(ndim, sp)
    out, grads = _out_and_grads(phase, x)
    _assert_close(out, grads, *_out_and_grads(plain, x))


def test_bf16_phase_net_stays_near_the_bf16_plain_net():
    """JAX's bf16 case: every level phased, within 0.05 of the output."""
    kw = dict(out_channels=1, ndim=3, filters=(4, 8), skip=(4,), dtype=torch.bfloat16)
    plain = MulResUnet(4, **kw)
    init_weights(plain, torch.Generator().manual_seed(0))
    phase = MulResUnet(4, **kw, phase_space=True, phase_levels=None)
    phase.load_state_dict(plain.state_dict())
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 4, 8, 8, 8).astype(np.float32))
    y_plain, y_phase = plain(x).float().detach(), phase(x).float().detach()
    scale = float(y_plain.abs().max())
    np.testing.assert_allclose(y_phase.numpy() / scale, y_plain.numpy() / scale, atol=0.05)


def test_the_parameter_tree_is_the_plain_nets():
    """Same names and shapes as the plain net's and the JAX phase net's, so
    a JAX phase run's weights load into either port net."""
    plain, phase = _nets(3, 2, 1)
    assert {k: v.shape for k, v in phase.state_dict().items()} == \
        {k: v.shape for k, v in plain.state_dict().items()}
    jm = JaxMulResUnet(**_kw(3), phase_space=True, phase_levels=2, phase_deep_levels=1)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 8, 8, IN_CH)))["params"]
    like = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    state_dict_to_jax_params(phase.state_dict(), like=like)   # raises on any difference


def test_remat_and_tapmm_compose_with_phase_space():
    """remat recomputes the phase blocks under the forward's formulation;
    tapmm runs every phase conv as per-tap products."""
    ndim, sp, levels, deep = CASES[3]
    x = _input(ndim, sp)
    _, phase = _nets(ndim, levels, deep)
    ref = _out_and_grads(phase, x)
    _, remat = _nets(ndim, levels, deep, remat=True)
    _assert_close(*_out_and_grads(remat, x), *ref)
    with conv_vjp.conv_impl("tapmm"):
        got = _out_and_grads(remat, x)
    _assert_close(*got, *ref)


def test_indivisible_sizes_raise_and_get_net_passes_the_levels():
    _, phase = _nets(3, 2, 1)
    with pytest.raises(ValueError, match="divisible by 4"):
        phase(torch.zeros(1, IN_CH, 16, 8, 6))
    cfg = Config(datadim="3d", inputdepth=IN_CH, filters=[4, 8, 16], skip=[4, 8],
                 phase_space=True, phase_levels=-1, phase_deep_levels=1)
    net = get_net(cfg)
    assert (net.phase_space, net.phase_levels, net.phase_deep_levels) == (True, None, 1)
    assert not get_net(Config(**{**cfg.to_dict(), "phase_levels": 0})).phase_space
