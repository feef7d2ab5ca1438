"""The gradient of the port's fused loss/metrics (ops/fused_loss.py) in ``out``:
every metric against ``jax.grad`` of the JAX package's Pallas kernel run in
interpret mode, on the same numpy inputs, and the plain backward against
autograd of the plain sums.

On the CPU the port takes the backward kernel's plain version; the CUDA
kernel itself is held against that plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu.ops.pallas_kernels import \
    fused_loss_metrics as jax_fused
from deep_prior_interpolation_tpu_torch.ops import fused_loss as FL

torch.set_num_threads(1)

DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16), "float32": (jnp.float32, torch.float32)}


def _problem(shape=(33, 50, 1), seed=3):
    rng = np.random.RandomState(seed)
    out = rng.randn(*shape).astype(np.float32)
    img = rng.randn(*shape).astype(np.float32)
    mask = (rng.rand(*shape) > 0.5).astype(np.float32)
    return out, img, mask


def _pick(result, metric):
    loss, mets = result
    return loss if metric == "loss" else mets[metric]


@functools.cache
def _jax_grad(metric, dtype):
    out, img, mask = _problem()
    g = jax.grad(lambda o: _pick(jax_fused(o, jnp.asarray(img), jnp.asarray(mask), "mae",
                                           interpret=True), metric))(
        jnp.asarray(out).astype(DTYPES[dtype][0]))
    return np.asarray(g.astype(jnp.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("metric", ["loss", "mae", "mse", "snr", "pcorr"])
def test_metric_gradient_matches_jax(metric, dtype):
    # the gradient is computed in float32 and rounded once to out's dtype, as
    # in the JAX package: bf16 pcorr and snr differ by a bf16 ulp otherwise
    out, img, mask = _problem()
    tdt = DTYPES[dtype][1]
    o = torch.from_numpy(out).to(tdt).requires_grad_(True)
    val = _pick(FL.fused_loss_metrics(o, torch.from_numpy(img), torch.from_numpy(mask),
                                      "mae"), metric)
    (grad,) = torch.autograd.grad(val, o)
    assert grad.dtype == tdt
    np.testing.assert_allclose(grad.float().numpy(), _jax_grad(metric, dtype), atol=1e-6)


def test_plain_backward_matches_autograd_of_the_plain_sums():
    out, img, mask = (torch.from_numpy(a) for a in _problem((20, 30, 1), seed=4))
    g = torch.from_numpy(np.random.RandomState(5).randn(8).astype(np.float32))
    o = out.clone().requires_grad_(True)
    (ref,) = torch.autograd.grad(FL.fused_sums_plain(o, img, mask), o, g)
    got = FL.loss_sums_grad_plain(out, img, mask, g)
    assert got.dtype == torch.float32
    # the same float32 terms, which autograd adds in another order
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6 * float(ref.abs().max()))


def test_cpu_tensors_take_the_plain_backward():
    before = (FL.fused_sums.launches, FL.loss_sums_grad.launches)
    out, img, mask = (torch.from_numpy(a) for a in _problem((8, 8, 1)))
    g = torch.arange(1.0, 9.0)
    got = FL.loss_sums_grad(out.to(torch.bfloat16), img, mask, g)
    o = out.to(torch.bfloat16).requires_grad_(True)
    FL.fused_loss_metrics(o, img, mask, "mse")[0].backward()
    assert (FL.fused_sums.launches, FL.loss_sums_grad.launches) == before
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(
        got, FL.loss_sums_grad_plain(out.to(torch.bfloat16), img, mask, g), rtol=0, atol=0)


def test_backward_wrapper_checks_its_inputs():
    out, img, mask = (torch.from_numpy(a) for a in _problem((8, 8, 1)))
    with pytest.raises(ValueError, match="shape"):
        FL.loss_sums_grad(out, img[:4], mask, torch.ones(8))
    with pytest.raises(ValueError, match="8"):
        FL.loss_sums_grad(out, img, mask, torch.ones(7))
