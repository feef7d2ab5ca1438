"""The port's partial-conv U-Net, attention nets and ConvGRU ensemble against
the JAX package's flax modules, with the parameters drawn by the port and
bridged to JAX (io/bridge.py): names, forward, gradients, the bridge both
ways (Dense kernels, flax nn.Conv kernels, nn.scan's broadcast parameters),
the flax initialisers, and one solve of the net that takes the mask."""
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


def _x(*shape, seed=3):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def forward_pair(jm, tm, *xs, seed=0):
    """(jax out, port out) with the port's weights bridged into the JAX module."""
    P.init_weights(tm, torch.Generator().manual_seed(seed), "xavier", 0.02)
    params = state_dict_to_jax_params(tm.state_dict())
    jout = jax.jit(jm.apply)({"params": params}, *[jnp.asarray(a) for a in xs])
    with torch.no_grad():
        tout = tm(*[_cf(a) for a in xs])
    return np.asarray(jout, np.float32), _cl(tout)


def run_pair(jm, tm, *xs, seed=0, out=lambda o: o):
    """(jax out, port out, jax grads as a state dict, port grads) of
    sum(out * cot), the port's weights bridged into the JAX module; ``out``
    picks the output of a module that returns several."""
    if not tm._built:  # a library component makes its children at its first call
        tm.build(*[_cf(a) for a in xs])
    P.init_weights(tm, torch.Generator().manual_seed(seed), "xavier", 0.02)
    params = state_dict_to_jax_params(tm.state_dict())
    jx = [jnp.asarray(a) for a in xs]
    shape = jax.eval_shape(lambda p: out(jm.apply({"params": p}, *jx)), params).shape
    cot = np.random.RandomState(seed + 1).randn(*shape).astype(np.float32)

    def f(p):
        o = out(jm.apply({"params": p}, *jx))
        return jnp.sum(o * cot), o
    jg, jout = jax.jit(jax.grad(f, has_aux=True))(params)
    jg = jax_params_to_state_dict(jax.device_get(jg), like=tm.state_dict())
    tout = out(tm(*[_cf(a) for a in xs]))
    (tout.float() * _cf(cot)).sum().backward()
    return np.asarray(jout, np.float32), _cl(tout), jg, {n: p.grad for n, p in tm.named_parameters()}


def check_pair(jout, tout, jg, tg, fwd=1e-5):
    """Forward to ``fwd`` of its largest value; every gradient to 1e-4 of
    its own largest entry plus 1e-6 of the largest gradient (the rounding
    floor of conv biases that feed a Norm)."""
    assert tout.shape == jout.shape
    np.testing.assert_allclose(tout, jout, rtol=0, atol=fwd * np.abs(jout).max())
    assert set(jg) == set(tg)
    g_max = max(float(g.abs().max()) for g in jg.values())
    for name, g in tg.items():
        ref = jg[name].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max() + 1e-6 * g_max, err_msg=name)


def _mask(*shape, seed=4):
    return (np.random.RandomState(seed).rand(*shape) > 0.5).astype(np.float32)


def test_partial_unet_matches_jax():
    # 2D here; the 3D net's names are held by the bridge test below, its
    # forward and backward at full size on the card (chip_smoke.py)
    shape = (1, 32, 32, 4)
    check_pair(*run_pair(J.PartialUNet(out_channels=1, ndim=2), P.PartialUNet(4, 1, 2),
                         _x(*shape), _mask(*shape)))


def test_partial_conv_renormalises_and_zeroes_holes():
    x, m = _x(1, 8, 8, 3), _mask(1, 8, 8, 3)
    m[:, :4] = 0.0  # a band of holes wider than the kernel
    jm = J.PartialConv(features=2, kernel_size=3, ndim=2, use_bias=True, use_norm=False,
                       act="none")
    check_pair(*run_pair(jm, P.PartialConv(2, 3, ndim=2, use_bias=True, use_norm=False,
                                           act="none"), x, m, out=lambda o: o[0]))
    # an all-ones kernel on a constant input gives exactly 1 where any
    # input is valid, 0 in the holes; the new mask marks the valid outputs
    pc = P.PartialConv(1, 3, ndim=2, use_norm=False, act="none").build(_cf(x[..., :1]),
                                                                       _cf(m[..., :1]))
    with torch.no_grad():
        pc.Conv_0.kernel.fill_(1.0)
        y, new = pc(torch.ones(1, 1, 8, 8), _cf(m[..., :1]))
    assert torch.all(y[0, 0, :3] == 0) and torch.all(new[0, 0, :3] == 0)
    torch.testing.assert_close(y[new > 0], torch.ones(int((new > 0).sum())))


def test_attention_gates_match_jax():
    check_pair(*run_pair(J.CBAM(reduction_ratio=4), P.CBAM(4), _x(2, 8, 8, 8)))
    check_pair(*run_pair(J.GridAttentionBlock(f_int=6), P.GridAttentionBlock(6),
                         _x(1, 5, 5, 12), _x(1, 10, 10, 4, seed=5)))


def test_attmultiunet_matches_jax():
    check_pair(*run_pair(J.AttMulResUnet(out_channels=1, filters=(4, 8)),
                         P.AttMulResUnet(4, 1, 2, (4, 8)), _x(1, 8, 8, 4)))


def test_attention_unet_matches_jax():
    # ~18 convs with Norm scales of 10 between them: float32 rounding grows
    # (its gates' and blocks' gradients are held in the tests above)
    jout, tout = forward_pair(J.AttentionUnet(out_channels=1), P.AttentionUnet(3, 1),
                              _x(1, 32, 32, 3))
    assert tout.shape == jout.shape == (1, 32, 32, 1)
    np.testing.assert_allclose(tout, jout, rtol=0, atol=1e-3 * np.abs(jout).max())


def test_convgru_cell_matches_jax():
    check_pair(*run_pair(J.ConvGRUCell(hidden=6), P.ConvGRUCell(6), _x(1, 8, 8, 4),
                         0.5 * _x(1, 8, 8, 6, seed=6)))


def test_ensemble_matches_jax():
    # the recurrent rollout chains a ResNet34 encoder and 2 x 7 decoder convs
    # (the cell's gradients are held above; at a 1 x 1 feature map the first
    # decoder Norm divides by sqrt(eps), so its gradients are rounding)
    jout, tout = forward_pair(J.Ensemble(out_channels=1, num_frames=2, hidden=8),
                              P.Ensemble(1, 1, 2, 8), _x(1, 32, 32, 1))
    assert tout.shape == jout.shape == (2, 32, 32, 1)
    np.testing.assert_allclose(tout, jout, rtol=0, atol=1e-3 * np.abs(jout).max())


NETS = {
    "part_3d": lambda: (J.PartialUNet(out_channels=1, ndim=3), P.PartialUNet(4, 1, 3),
                        [(1, 32, 32, 32, 4)] * 2),
    "attmultiunet": lambda: (J.AttMulResUnet(out_channels=1, filters=(4, 8)),
                             P.AttMulResUnet(4, 1, 2, (4, 8)), [(1, 16, 16, 4)]),
    "attention_unet": lambda: (J.AttentionUnet(out_channels=1), P.AttentionUnet(3, 1),
                               [(1, 16, 16, 3)]),
    "ensemble": lambda: (J.Ensemble(out_channels=1, num_frames=2, hidden=8),
                         P.Ensemble(1, 1, 2, 8), [(1, 32, 32, 1)]),
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_bridge_round_trips_with_flax_names(name):
    jm, tm, shapes = NETS[name]()
    tree = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                          *[jnp.zeros(s) for s in shapes])["params"]
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), tree)
    jax_params_to_state_dict(zeros, like=tm.state_dict())  # every leaf, every shape
    P.init_weights(tm, torch.Generator().manual_seed(1), "normal", 1.0)
    there = state_dict_to_jax_params(tm.state_dict(), like=zeros)
    back = jax_params_to_state_dict(there, like=tm.state_dict())
    for k, v in tm.state_dict().items():
        assert torch.equal(back[k], v), k
    again = dict(jax.tree_util.tree_leaves_with_path(state_dict_to_jax_params(back)))
    for path, leaf in jax.tree_util.tree_leaves_with_path(there):
        np.testing.assert_array_equal(again[path], leaf)


def test_init_weights_draws_every_leaf_the_jax_package_draws():
    m = P.Ensemble(1, 1, 1, 8)
    P.init_weights(m, torch.Generator().manual_seed(0), "xavier", 0.02)
    gate = m.Scan_RolloutStep_0.ConvGRUCell_0.update_gate.kernel  # rank 4: xavier
    std = 0.02 * np.sqrt(2.0 / (9 * gate.shape[1] + 9 * gate.shape[0]))
    assert abs(float(gate.detach().std()) / std - 1) < 0.1
    scale = m.Encoder_0.Norm_0.scale
    assert abs(float(scale.detach().mean()) - 10.0) < 0.5
    # 'default': each flax module's own initialiser
    P.init_weights(m, torch.Generator().manual_seed(0), "default")
    q = gate.detach().permute(2, 3, 1, 0).reshape(-1, gate.shape[0])  # the (9 I, O) matrix
    torch.testing.assert_close(q.T @ q, torch.eye(gate.shape[0]), rtol=0, atol=1e-5)
    pm = P.PartialUNet(4, 1, 2)
    P.init_weights(pm, torch.Generator().manual_seed(0), "default")
    k = pm.PartialBlock_0.PartialConv_0.Conv_0.kernel.detach()  # kaiming normal, fan_in 36
    assert abs(float(k.std()) / np.sqrt(2.0 / 36) - 1) < 0.1
    cb = P.CBAM(4).build(torch.zeros(1, 16, 4, 4))
    P.init_weights(cb, torch.Generator().manual_seed(0), "xavier", 0.02)
    dense = cb.ChannelGate_0.Dense_0.kernel.detach()  # (4, 16): lecun normal, fan_in 16
    assert 0.5 < float(dense.std()) / np.sqrt(1.0 / 16) < 1.5
    assert torch.all(cb.ChannelGate_0.Dense_0.bias == 0)


def test_factory_refuses_what_the_jax_package_refuses():
    assert isinstance(P.get_net(Config(net="part", inputdepth=4), 1), P.PartialUNet)
    assert isinstance(P.get_net(Config(net="attmultiunet", filters=[4, 8], skip=[4],
                                       inputdepth=4), 1), P.AttMulResUnet)
    with pytest.raises(ValueError, match="2D-only"):
        P.get_net(Config(datadim="3d", net="attmultiunet"), 1)


def test_partial_unet_solve_matches_jax():
    """The net that takes the mask: the solver hands it the sampling mask
    tiled to the input depth on the padded canvas."""
    t = np.linspace(0, 1, 30)[:, None]
    img = np.sin(2 * np.pi * (3 * t + 2 * np.linspace(0, 1, 28)[None, :]))
    img = img.astype(np.float32)[..., None]
    mask = np.repeat(_mask(1, 28), 30, 0)[..., None]
    kw = dict(datadim="2d", net="part", epochs=3, scan_chunk=3, inputdepth=4, gain=1.0,
              reg_noise_std=0.0, inittype="default")
    port = DIPSolver(Config(**kw), device="cpu")
    P.init_weights(port.model, torch.Generator().manual_seed(0), "default")
    init = {k: v.clone() for k, v in port.model.state_dict().items()}
    ref = JaxDIPSolver(JaxConfig(**kw), outchannel=1).solve(
        img, mask, seed=0, init_params=state_dict_to_jax_params(init))
    k_noise = jax.random.split(jax.random.PRNGKey(0), 3)[0]
    from deep_prior_interpolation_tpu.engine import build_base_input
    canvas = np.asarray(build_base_input(JaxConfig(**kw), k_noise, (32, 32)))[0]
    got = port.solve(img, mask, seed=0, init_params=init, noise=canvas)
    np.testing.assert_allclose(got.history.loss, ref.history.loss, rtol=2e-4)
    np.testing.assert_allclose(got.out_best, ref.out_best, rtol=1e-3, atol=1e-4)
