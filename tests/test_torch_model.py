"""The port's MulResUnet and blocks against the JAX package's flax modules,
with the JAX parameters bridged into the port (io/bridge.py)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu.models import MulResUnet as JaxMulResUnet
from deep_prior_interpolation_tpu.models import Conv as JaxConv
from deep_prior_interpolation_tpu.models import Norm as JaxNorm
from deep_prior_interpolation_tpu.models import upsample as jax_upsample
from deep_prior_interpolation_tpu_torch.io import (jax_params_to_state_dict,
                                                   state_dict_to_jax_params)
from deep_prior_interpolation_tpu_torch.models import (Conv, MulResUnet, Norm,
                                                       init_weights, upsample)

torch.set_num_threads(1)

IN_CH = 4


def _to_torch(a: np.ndarray) -> torch.Tensor:
    """(1, *spatial, C) -> (1, C, *spatial)."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """(1, C, *spatial) -> (1, *spatial, C) float32."""
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


def _pair(ndim, spatial, filters, skip, upsample_mode, dtype=None, seed=0):
    """(jax module, jax params, port module with the same params, input,
    cotangent). The port draws the parameters; the bridge hands them to JAX."""
    jm = JaxMulResUnet(out_channels=1, ndim=ndim, filters=filters, skip=skip,
                       upsample_mode=upsample_mode,
                       dtype=jnp.bfloat16 if dtype == "bf16" else None)
    tm = MulResUnet(IN_CH, 1, ndim, filters, skip, upsample_mode=upsample_mode,
                    dtype=torch.bfloat16 if dtype == "bf16" else None)
    init_weights(tm, torch.Generator().manual_seed(seed), "xavier", 0.02)
    params = state_dict_to_jax_params(tm.state_dict())
    rng = np.random.RandomState(seed)
    x = rng.randn(1, *spatial, IN_CH).astype(np.float32)
    cot = rng.randn(1, *spatial, 1).astype(np.float32)
    return jm, params, tm, x, cot


CASES = {2: ((32, 16), (4, 8), (4,), "nearest"),
         3: ((16, 16, 16), (4, 8, 16), (4, 4), "trilinear")}


@functools.lru_cache(maxsize=None)
def _f32_case(ndim):
    """One jitted JAX forward+gradient per rank, shared by the tests below:
    (jax out, port out, jax grads, port grads, port module, input)."""
    jm, params, tm, x, cot = _pair(ndim, *CASES[ndim])

    def f(p):
        out = jm.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(out * cot), out
    jg, jout = jax.jit(jax.grad(f, has_aux=True))(params)
    jg = jax_params_to_state_dict(jax.device_get(jg), like=tm.state_dict())
    tout = tm(_to_torch(x))
    (tout.float() * _to_torch(cot)).sum().backward()
    tg = {n: p.grad for n, p in tm.named_parameters()}
    return np.asarray(jout, np.float32), _to_numpy(tout), jg, tg


def _kind(name: str) -> str:
    """'Conv.kernel', 'Conv.bias', 'Norm.scale' or 'Norm.bias'."""
    module, leaf = name.split(".")[-2:]
    return f"{module.split('_')[0]}.{leaf}"


# f32: convs and Norm statistics sum in other orders in XLA and PyTorch.
# Each gradient is held to 1e-4 of its own largest entry, plus a rounding
# floor of 1e-5 of the largest gradient of its kind: some gradients are zero
# up to rounding (a Norm scale whose output a per-channel Norm rescales), and
# there each framework's rounding noise is its own.
F32_TOL = 1e-4
FLOOR = 1e-5


@pytest.mark.parametrize("ndim", [2, 3])
def test_forward_and_gradients_match_jax_f32(ndim):
    spatial, filters, _, _ = CASES[ndim]
    jout, tout, jg, tg = _f32_case(ndim)
    assert tout.shape == jout.shape == (1, *spatial, 1)
    np.testing.assert_allclose(tout, jout, rtol=0, atol=F32_TOL * np.abs(jout).max())
    assert set(jg) == set(tg)
    kind_max = {}
    for n, g in jg.items():
        kind_max[_kind(n)] = max(kind_max.get(_kind(n), 0.0), float(g.abs().max()))
    g_max = max(kind_max.values())
    for name, g in tg.items():
        ref = jg[name].numpy()
        if _feeds_a_norm(name, ndim, len(filters)):
            # the Norm removes any bias: the gradient is zero up to rounding
            assert np.abs(g.numpy()).max() <= 1e-3 * g_max, name
            assert np.abs(ref).max() <= 1e-3 * g_max, name
            continue
        atol = F32_TOL * np.abs(ref).max() + FLOOR * kind_max[_kind(name)]
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=atol, err_msg=name)


def _feeds_a_norm(name: str, ndim: int, n_levels: int) -> bool:
    """Is ``name`` the bias of a conv whose output goes straight into a Norm?
    (Every ConvNormAct's conv; in 3D also the downsampling convs, all top
    Conv_i but the head Conv_{n_levels-1}.)"""
    if name.endswith("Conv_0.bias") and "ConvNormAct_" in name:
        return True
    parts = name.split(".")
    return (ndim == 3 and len(parts) == 2 and parts[1] == "bias"
            and parts[0].startswith("Conv_") and parts[0] != f"Conv_{n_levels - 1}")


def test_forward_matches_jax_bf16_3d():
    jm, params, tm, x, _ = _pair(3, *CASES[3], dtype="bf16")
    jout = np.asarray(jax.jit(jm.apply)({"params": params},
                                        jnp.asarray(x).astype(jnp.bfloat16)), np.float32)
    tout = _to_numpy(tm(_to_torch(x).bfloat16()))
    j32 = _f32_case(3)[0]

    def err(a, b):
        return np.abs(a - b).max() / np.abs(b).max(), np.abs(a - b).mean() / np.abs(b).mean()
    # bf16 rounds at other places in XLA and PyTorch (8 mantissa bits through
    # ~20 layers): the two bf16 nets may differ as much as JAX's bf16 net
    # differs from its f32 net (measured: 5.4 % / 3.5 % against 6.9 % / 3.5 %
    # of the output, max / mean), not more
    e_port = err(tout, jout)
    e_jax = err(jout, j32)
    assert e_port[0] <= 1.25 * e_jax[0] and e_port[1] <= 1.25 * e_jax[1], (e_port, e_jax)
    assert np.corrcoef(tout.ravel(), jout.ravel())[0, 1] > 0.998


def test_norm_matches_jax():
    rng = np.random.RandomState(1)
    x = (3.0 + 2.0 * rng.randn(1, 5, 7, 9, 6)).astype(np.float32)
    scale, bias = rng.randn(6).astype(np.float32), rng.randn(6).astype(np.float32)
    jy = JaxNorm().apply({"params": {"scale": scale, "bias": bias}}, jnp.asarray(x))
    n = Norm(6)
    n.load_state_dict({"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    np.testing.assert_allclose(_to_numpy(n(_to_torch(x))), np.asarray(jy), rtol=1e-5, atol=1e-5)
    jyb = JaxNorm().apply({"params": {"scale": scale, "bias": bias}},
                          jnp.asarray(x).astype(jnp.bfloat16))
    tyb = n(_to_torch(x).bfloat16())
    assert tyb.dtype == torch.bfloat16
    np.testing.assert_allclose(_to_numpy(tyb), np.asarray(jyb, np.float32), rtol=0, atol=0.05)


@pytest.mark.parametrize("spatial", [(5, 7, 3), (6, 4, 9)])
def test_upsample_linear_matches_jax_resize(spatial):
    x = np.random.RandomState(2).randn(1, *spatial, 3).astype(np.float32)
    jy = jax_upsample(jnp.asarray(x[0]), 2, "trilinear")[None]
    ty = upsample(_to_torch(x), 2, "trilinear")
    np.testing.assert_allclose(_to_numpy(ty), np.asarray(jy), rtol=1e-5, atol=1e-6)
    jn = jax_upsample(jnp.asarray(x[0]), 2, "nearest")[None]
    np.testing.assert_array_equal(_to_numpy(upsample(_to_torch(x), 2, "nearest")),
                                  np.asarray(jn))


@pytest.mark.parametrize("ndim,spatial", [(2, (9, 7)), (3, (5, 9, 7))])
def test_stride2_conv_on_odd_sizes_matches_jax(ndim, spatial):
    rng = np.random.RandomState(3)
    x = rng.randn(1, *spatial, 3).astype(np.float32)
    k = (0.3 * rng.randn(*(3,) * ndim, 3, 5)).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    jy = JaxConv(5, 3, stride=2, ndim=ndim).apply({"params": {"kernel": k, "bias": b}},
                                                  jnp.asarray(x))
    conv = Conv(3, 5, 3, stride=2, ndim=ndim)
    conv.load_state_dict(jax_params_to_state_dict({"kernel": k, "bias": b}))
    ty = conv(_to_torch(x))
    assert ty.shape[2:] == tuple(-(-s // 2) for s in spatial)
    np.testing.assert_allclose(_to_numpy(ty), np.asarray(jy), rtol=1e-5, atol=1e-5)


def test_bridge_round_trips_exactly():
    _, params, tm, _, _ = _pair(3, *CASES[3])
    there = jax_params_to_state_dict(params, like=tm.state_dict())
    for k, v in tm.state_dict().items():
        torch.testing.assert_close(there[k], v, rtol=0, atol=0)
    back = state_dict_to_jax_params(there, like=params)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], np.asarray(leaf))


def test_bridge_refuses_unused_leaves_and_bad_shapes():
    _, params, tm, _, _ = _pair(2, *CASES[2])
    extra = dict(params, Extra_0={"kernel": np.zeros((3, 3, 1, 1), np.float32)})
    with pytest.raises(KeyError, match="unused"):
        jax_params_to_state_dict(extra, like=tm.state_dict())
    bad = jax.tree_util.tree_map(np.asarray, params)
    bad["Conv_0"]["bias"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match="shape"):
        jax_params_to_state_dict(bad, like=tm.state_dict())
    with pytest.raises(KeyError, match="missing"):
        state_dict_to_jax_params({k: v for k, v in tm.state_dict().items()
                                  if k != "Conv_0.bias"}, like=params)


def test_child_names_follow_flax():
    jm, _, tm, x, _ = _pair(3, *CASES[3])
    flax_params = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    jax_params_to_state_dict(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                                    flax_params), like=tm.state_dict())
    assert set(flax_params) == {n for n, _ in tm.named_children() if n[0].isupper()}


def test_init_weights_distribution():
    # xavier: std = gain * sqrt(2 / (fan_in + fan_out)) with the DHWIO fans
    m = MulResUnet(64, 1, 3, (16, 32), (16,))
    init_weights(m, torch.Generator().manual_seed(0), "xavier", 0.02)
    k = m.MultiResBlock_0.ConvNormAct_0.Conv_0.kernel.detach()
    co, ci = k.shape[:2]
    want = 0.02 * np.sqrt(2.0 / (27 * ci + 27 * co))
    assert abs(float(k.std()) / want - 1) < 0.05
    scale = m.MultiResBlock_0.ConvNormAct_0.Norm_0.scale.detach()
    assert abs(float(scale.mean()) - 10.0) < 0.5
    assert float(m.MultiResBlock_0.ConvNormAct_0.Conv_0.bias.detach().abs().max()) == 0.0


def test_default_init_draws_flax_initialisers():
    # 'default' keeps flax's own initialisers: lecun-normal kernels (truncated
    # at 2 std, fans of the DHWIO kernel), Norm scale 1, biases 0
    m = MulResUnet(64, 1, 3, (16, 32), (16,))
    init_weights(m, torch.Generator().manual_seed(0), "default")
    k = m.MultiResBlock_0.ConvNormAct_0.Conv_0.kernel.detach()
    ref = np.asarray(jax.nn.initializers.lecun_normal()(
        jax.random.PRNGKey(0), tuple(k.permute(2, 3, 4, 1, 0).shape)))
    assert abs(float(k.std()) / float(ref.std()) - 1) < 0.05
    assert float(k.abs().max()) <= np.abs(ref).max() * 1.01
    for name, p in m.named_parameters():
        if name.endswith("scale"):
            assert torch.all(p == 1.0), name
        elif name.endswith("bias"):
            assert torch.all(p == 0.0), name
