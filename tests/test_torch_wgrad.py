"""The port's 3D weight gradient (ops/wgrad.py) and conv_same (ops/conv_vjp.py)
against the JAX package's Pallas wgrad in interpret mode, JAX's conv_same and
``torch.nn.grad.conv3d_weight``, on the same numpy inputs.

On the CPU the port takes the kernel's plain version; the CUDA kernel is held
against it on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu.ops import conv_vjp as jax_conv_vjp
from deep_prior_interpolation_tpu.ops.pallas_wgrad import pallas_wgrad_s1
from deep_prior_interpolation_tpu_torch.ops import conv_vjp
from deep_prior_interpolation_tpu_torch.ops import wgrad as WG

torch.set_num_threads(1)

# shapes of tests/test_pallas_wgrad.py: (spatial, k, ci, co)
SHAPES = [((6, 8, 16), 3, 5, 3), ((4, 8, 8), 3, 8, 4), ((5, 16, 8), 5, 3, 2)]


def _ncdhw(a: np.ndarray) -> torch.Tensor:
    """(1, D, H, W, C) numpy -> (1, C, D, H, W) tensor."""
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 4, 1, 2, 3)))


def _dhwio(w: torch.Tensor) -> np.ndarray:
    """(O, I, D, H, W) tensor -> (D, H, W, I, O) numpy."""
    return w.permute(2, 3, 4, 1, 0).float().numpy()


def _inputs(sp, ci, co, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(1, *sp, ci).astype(np.float32)
    dy = rng.randn(1, *sp, co).astype(np.float32)
    return x, dy


@pytest.mark.parametrize("sp,k,ci,co", SHAPES)
def test_plain_matches_jax_pallas_and_torch(sp, k, ci, co):
    x, dy = _inputs(sp, ci, co, seed=11)
    ref = np.asarray(pallas_wgrad_s1(jnp.asarray(x), jnp.asarray(dy), k, interpret=True))
    got = WG.wgrad3d(_ncdhw(x), _ncdhw(dy), k)
    assert got.dtype == torch.float32 and got.shape == (co, ci, k, k, k)
    np.testing.assert_allclose(_dhwio(got), ref, rtol=2e-5, atol=2e-4)
    lib = torch.nn.grad.conv3d_weight(_ncdhw(x), (co, ci, k, k, k), _ncdhw(dy),
                                      stride=1, padding=(k - 1) // 2)
    np.testing.assert_allclose(got.numpy(), lib.numpy(), rtol=2e-5, atol=2e-4)


def test_bf16_inputs_accumulate_in_f32():
    x, dy = _inputs((4, 8, 8), 6, 4, seed=17)
    xb, dyb = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(dy).astype(jnp.bfloat16)
    ref16 = np.asarray(pallas_wgrad_s1(xb, dyb, 3, interpret=True))
    got = WG.wgrad3d(_ncdhw(x).bfloat16(), _ncdhw(dy).bfloat16(), 3)
    assert got.dtype == torch.float32
    # exact bf16 products summed in float32 in other orders
    np.testing.assert_allclose(_dhwio(got), ref16, rtol=1e-5, atol=1e-4)
    ref32 = np.asarray(pallas_wgrad_s1(jnp.asarray(x), jnp.asarray(dy), 3, interpret=True))
    # against float32 inputs: the bf16 rounding of x and dy (tests/test_pallas_wgrad.py)
    np.testing.assert_allclose(_dhwio(got), ref32, rtol=0.05, atol=0.1)


def test_conv_same_grads_match_jax_with_the_switch_on(monkeypatch):
    monkeypatch.setenv("DPI_PALLAS_WGRAD", "1")
    sp, k, ci, co = (6, 8, 16), 3, 5, 4
    rng = np.random.RandomState(13)
    x = rng.randn(1, *sp, ci).astype(np.float32)
    w = (0.1 * rng.randn(k, k, k, ci, co)).astype(np.float32)
    cot = rng.randn(1, *sp, co).astype(np.float32)
    pads = ((1, 1),) * 3
    assert jax_conv_vjp._use_pallas(jnp.asarray(x), jnp.asarray(w), 1, pads)
    gx, gw = jax.grad(lambda xx, ww: jnp.sum(jax_conv_vjp.conv_same(xx, ww, 1, pads)
                                             * cot), (0, 1))(jnp.asarray(x), jnp.asarray(w))

    calls = []
    real = conv_vjp.wgrad3d
    monkeypatch.setattr(conv_vjp, "wgrad3d",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    xt = _ncdhw(x).requires_grad_(True)
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2))).requires_grad_(True)
    y = conv_vjp.conv_same(xt, wt, 1, 1)
    (y * _ncdhw(cot)).sum().backward()
    assert calls == [xt.shape]  # dW came from the wgrad kernel's wrapper
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 4, 1).numpy(), np.asarray(gx),
                               rtol=2e-5, atol=2e-4, err_msg="dx")
    np.testing.assert_allclose(_dhwio(wt.grad), np.asarray(gw), rtol=2e-5, atol=2e-4,
                               err_msg="dw")


def test_conv_same_dw_keeps_the_weight_dtype(monkeypatch):
    monkeypatch.setenv("DPI_PALLAS_WGRAD", "1")
    x = torch.randn(1, 3, 4, 8, 8).bfloat16()
    w = torch.randn(2, 3, 3, 3, 3).bfloat16().requires_grad_(True)
    conv_vjp.conv_same(x, w, 1, 1).float().sum().backward()
    assert w.grad.dtype == torch.bfloat16
    ref = WG.wgrad3d_plain(x, torch.ones(1, 2, 4, 8, 8).bfloat16(), 3).bfloat16()
    torch.testing.assert_close(w.grad, ref, rtol=0, atol=0)


def test_switch_off_uses_torch_weight_grad(monkeypatch):
    monkeypatch.setenv("DPI_PALLAS_WGRAD", "0")
    monkeypatch.setattr(conv_vjp, "wgrad3d", lambda *a: pytest.fail("kernel called"))
    x = torch.randn(1, 3, 4, 8, 8)
    w = torch.randn(2, 3, 3, 3, 3, requires_grad=True)
    conv_vjp.conv_same(x, w, 1, 1).sum().backward()
    assert w.grad.shape == w.shape
