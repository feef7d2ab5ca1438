"""Every op of a caller's module over spatial shards against the JAX
package, which shards any flax module (GSPMD partitions the step,
gathering an operand where it has no partitioned form): the JAX
``DIPSolver(model=JWrapped).solve`` with ``spatial_mesh=
make_spatial_mesh(8)`` on its 8 virtual CPU devices (tests/conftest.py)
and the port's ``DIPSolver(model=Wrapped)`` over ``[cpu] * 8`` on the
sharded walker, along axis 1, in float32 from the port's parameters (the
MulResUnet body bridged by ``io/bridge.py``, the glue mapped here) and the
JAX run's canvas, with no per-step noise. ``JWrapped`` is the flax twin of
``Wrapped``: a ``padding="VALID"`` conv re-padded by zeros, ``jnp.roll``
and ``jnp.flip``, a slice re-padded by ``jnp.pad(mode="wrap")``, an
``rfft``/``irfft`` low-pass, all along the sharded axis, a
``jax.lax.stop_gradient`` scale and a ``jax.custom_vjp`` (the port's
``torch.no_grad()`` region and custom ``autograd.Function``). The patch is
(24, 64), 8 planes a shard: XLA's SPMD FFT handler aborts on a (24, 32)
patch over 8 shards along axis 1 (ROADMAP D.10). The first 5 losses agree
to rtol 1e-3; the port's walk gathered only the FFT pair and the
Function."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import deep_prior_interpolation_tpu.models as J
from deep_prior_interpolation_tpu.config import Config as JaxConfig
from deep_prior_interpolation_tpu.engine import DIPSolver as JaxDIPSolver
from deep_prior_interpolation_tpu.parallel import make_spatial_mesh as jax_make_spatial_mesh
from deep_prior_interpolation_tpu_torch import Config, DIPSolver
from deep_prior_interpolation_tpu_torch.io import state_dict_to_jax_params
from deep_prior_interpolation_tpu_torch.models import get_net, init_weights
from deep_prior_interpolation_tpu_torch.parallel import make_spatial_mesh
from test_torch_spatial_custom import _patch

torch.set_num_threads(1)
KW = dict(datadim="2d", epochs=6, inputdepth=4, filters=[8, 16], skip=[4], scan_chunk=6,
          gain=1.0, reg_noise_std=0.0, dtype="float32", upsample="linear")
KEEP = 12   # the low-pass keeps the first 12 frequencies along the axis


class Twice(torch.autograd.Function):
    """Twice its input; its own backward twice the cotangent."""

    @staticmethod
    def forward(ctx, x):
        return 2.0 * x

    @staticmethod
    def backward(ctx, g):
        return 2.0 * g


class Wrapped(nn.Module):
    """A MulResUnet body beside glue that takes every new route along the
    sharded (last) axis."""

    def __init__(self, cfg):
        super().__init__()
        self.body = get_net(cfg, 1)
        self.pre = nn.Conv2d(cfg.inputdepth, 4, 3)
        self.head = nn.Conv2d(4, 1, 1)
        self.scale = nn.Parameter(torch.tensor(0.5))

    def forward(self, x):
        h = F.pad(F.leaky_relu(self.pre(x), 0.2), (1, 1, 1, 1))
        h = torch.roll(h, 3, dims=-1) + torch.flip(h, dims=[-1])
        h = F.pad(h[..., 1:-1], (1, 1, 0, 0), mode="circular")
        spec = torch.fft.rfft(h, dim=-1)
        low = (torch.arange(spec.shape[-1], device=h.device) < KEEP).to(h.dtype)
        h = torch.fft.irfft(spec * low, n=h.shape[-1], dim=-1)
        with torch.no_grad():
            top = h.abs().amax()
        h = Twice.apply(h / (1.0 + top))
        return self.body(x) + self.scale * self.head(h)


@jax.custom_vjp
def _twice(x):
    return 2.0 * x


_twice.defvjp(lambda x: (2.0 * x, None), lambda _, g: (2.0 * g,))


class JWrapped(fnn.Module):
    """The flax twin of ``Wrapped`` (channels-last: the sharded axis is
    array axis 2)."""

    body: fnn.Module

    @fnn.compact
    def __call__(self, x):
        h = fnn.leaky_relu(fnn.Conv(4, (3, 3), padding="VALID", name="pre")(x), 0.2)
        h = jnp.pad(h, ((0, 0), (1, 1), (1, 1), (0, 0)))
        h = jnp.roll(h, 3, axis=2) + jnp.flip(h, axis=2)
        h = jnp.pad(h[:, :, 1:-1], ((0, 0), (0, 0), (1, 1), (0, 0)), mode="wrap")
        spec = jnp.fft.rfft(h, axis=2)
        low = (jnp.arange(spec.shape[2]) < KEEP).astype(h.dtype)[None, None, :, None]
        h = jnp.fft.irfft(spec * low, n=h.shape[2], axis=2)
        top = jax.lax.stop_gradient(jnp.max(jnp.abs(h)))
        h = _twice(h / (1.0 + top))
        scale = self.param("scale", fnn.initializers.constant(0.5), ())
        return self.body(x) + scale * fnn.Conv(1, (1, 1), name="head")(h)


def _jax_params(state):
    """The port's state dict as ``JWrapped``'s tree: the body through the
    bridge, the torch convs' (O, I, kh, kw) as (kh, kw, I, O)."""
    sd = {k: v.detach().numpy() for k, v in state.items()}

    def conv(name):
        return {"kernel": np.transpose(sd[f"{name}.weight"], (2, 3, 1, 0)),
                "bias": sd[f"{name}.bias"]}
    return {"body": state_dict_to_jax_params({k[5:]: v for k, v in state.items()
                                              if k.startswith("body.")}),
            "pre": conv("pre"), "head": conv("head"),
            "scale": np.asarray(sd["scale"], np.float32)}


@pytest.fixture(scope="module")
def solves():
    img, mask = _patch(24, 64)
    torch.manual_seed(0)
    port = DIPSolver(Config(**KW), device="cpu", model=Wrapped(Config(**KW)))
    init_weights(port.model, torch.Generator().manual_seed(0), "xavier", 0.02)
    init = {k: v.clone() for k, v in port.model.state_dict().items()}
    jcfg = JaxConfig(**KW)
    ref = JaxDIPSolver(jcfg, outchannel=1, model=JWrapped(body=J.get_net(jcfg, 1))).solve(
        img, mask, seed=0, init_params=_jax_params(init),
        spatial_mesh=jax_make_spatial_mesh(8), spatial_axis=1)
    canvas = np.asarray(ref.noise, np.float32)
    got = port.solve(img, mask, seed=0, init_params=init, noise=canvas,
                     spatial_mesh=make_spatial_mesh(8, [torch.device("cpu")] * 8),
                     spatial_axis=1)
    return ref, got, canvas


def test_the_sharded_solve_of_every_route_follows_the_jax_one(solves):
    ref, got, _ = solves
    np.testing.assert_allclose(got.history.loss[:5], ref.history.loss[:5], rtol=1e-3)
    assert got.iters_run == ref.iters_run == 6


def test_it_gathered_only_the_fft_pair_and_the_function(solves):
    ref, got, canvas = solves
    assert [o.name for o in got.whole_ops] == ["torch.fft.rfft", "torch.fft.irfft",
                                              "Twice.apply"]
    np.testing.assert_array_equal(got.noise, canvas)
    assert got.out_best.shape == np.asarray(ref.out_best).shape
    assert np.all(np.isfinite(got.out_best))
