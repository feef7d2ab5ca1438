"""The port's fused loss/metrics (ops/fused_loss.py) against the JAX package's
Pallas kernel run in interpret mode, on the same numpy inputs.

On the CPU the port takes the kernels' plain versions; the CUDA kernels
themselves are held against those plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py). The gradient of every metric is
tested in tests/test_torch_fused_loss_grad.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu.ops import masked_mae as jax_masked_mae
from deep_prior_interpolation_tpu.ops.pallas_kernels import \
    fused_loss_metrics as jax_fused
from deep_prior_interpolation_tpu_torch.ops import fused_loss as FL
from deep_prior_interpolation_tpu_torch.ops import losses as L

torch.set_num_threads(1)

# tolerances of tests/test_pallas.py: loss rtol 1e-5, snr 1e-4, pcorr 1e-3,
# gradient atol 1e-6
RTOL = {"loss": 1e-5, "mae": 1e-5, "mse": 1e-5, "snr": 1e-4, "pcorr": 1e-3}


def _problem(shape, seed=0):
    rng = np.random.RandomState(seed)
    out = rng.randn(*shape).astype(np.float32)
    img = rng.randn(*shape).astype(np.float32)
    mask = (rng.rand(*shape) > 0.5).astype(np.float32)
    return out, img, mask


def _both(out, img, mask, loss, out_dtype=np.float32):
    jl, jm = jax_fused(jnp.asarray(out).astype(out_dtype), jnp.asarray(img),
                       jnp.asarray(mask), loss, interpret=True)
    tdt = torch.bfloat16 if out_dtype == jnp.bfloat16 else torch.float32
    tl, tm = FL.fused_loss_metrics(torch.from_numpy(out).to(tdt),
                                   torch.from_numpy(img), torch.from_numpy(mask), loss)
    j = {"loss": jl, **jm}
    t = {"loss": tl, **tm}
    return ({k: float(v) for k, v in j.items()}, {k: float(v) for k, v in t.items()})


@pytest.mark.parametrize("loss", ["mae", "mse", "l1"])
def test_values_match_jax(loss):
    j, t = _both(*_problem((33, 50, 1)), loss)
    for k, rtol in RTOL.items():
        np.testing.assert_allclose(t[k], j[k], rtol=rtol, err_msg=k)


def test_l1_alias_is_mae():
    out, img, mask = (torch.from_numpy(a) for a in _problem((33, 50, 1)))
    l1 = FL.fused_loss_metrics(out, img, mask, "l1")[0]
    np.testing.assert_allclose(float(l1), float(L.masked_mae(out, img, mask)), rtol=1e-5)


def test_nonaligned_size_matches_jax():
    # a size that is no multiple of any block: the ragged tail loads zeros
    out, img, _ = _problem((37, 41, 3), seed=1)
    j, t = _both(out, img, np.ones_like(out), "mse")
    for k, rtol in RTOL.items():
        np.testing.assert_allclose(t[k], j[k], rtol=rtol, err_msg=k)


def test_bf16_out_matches_jax():
    j, t = _both(*_problem((33, 50, 1), seed=2), "mae", out_dtype=jnp.bfloat16)
    for k, rtol in RTOL.items():
        np.testing.assert_allclose(t[k], j[k], rtol=rtol, err_msg=k)


@pytest.mark.parametrize("loss,out_dtype", [("mae", np.float32), ("mse", np.float32),
                                            ("l1", np.float32), ("mae", jnp.bfloat16)])
def test_gradient_matches_jax(loss, out_dtype):
    out, img, mask = _problem((33, 50, 1), seed=3)
    gj = jax.grad(lambda o: jax_fused(o, jnp.asarray(img), jnp.asarray(mask), loss,
                                      interpret=True)[0])(
        jnp.asarray(out).astype(out_dtype))
    tdt = torch.bfloat16 if out_dtype == jnp.bfloat16 else torch.float32
    o = torch.from_numpy(out).to(tdt).requires_grad_(True)
    FL.fused_loss_metrics(o, torch.from_numpy(img), torch.from_numpy(mask), loss)[0].backward()
    assert o.grad.dtype == tdt
    np.testing.assert_allclose(o.grad.float().numpy(), np.asarray(gj, np.float32), atol=1e-6)


def test_gradient_matches_plain_autograd():
    out, img, mask = (torch.from_numpy(a) for a in _problem((20, 30, 1), seed=4))
    o1 = out.clone().requires_grad_(True)
    FL.fused_loss_metrics(o1, img, mask, "mae")[0].backward()
    o2 = out.clone().requires_grad_(True)
    L.masked_mae(o2, img, mask).backward()
    np.testing.assert_allclose(o1.grad.numpy(), o2.grad.numpy(), atol=1e-6)
    g = jax.grad(lambda o: jax_masked_mae(o, jnp.asarray(img.numpy()),
                                          jnp.asarray(mask.numpy())))(jnp.asarray(out.numpy()))
    np.testing.assert_allclose(o1.grad.numpy(), np.asarray(g), atol=1e-6)


def test_cpu_tensor_takes_the_plain_version():
    before = FL.fused_sums.launches
    out, img, mask = (torch.from_numpy(a) for a in _problem((8, 8, 1)))
    s = FL.fused_sums(out, img, mask)
    assert FL.fused_sums.launches == before
    np.testing.assert_array_equal(s.numpy(), FL.fused_sums_plain(out, img, mask).numpy())

