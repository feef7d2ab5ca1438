"""A module of the caller's own over spatial shards against the JAX
package, which shards any flax module (GSPMD partitions the step): the
JAX ``DIPSolver(model=JCaller).solve`` with ``spatial_mesh=
make_spatial_mesh(8)`` on its 8 virtual CPU devices (tests/conftest.py)
and the port's ``DIPSolver(model=Caller)`` over ``[cpu] * 8`` on the
sharded walker, along axis 1 of a (24, 32) patch (4 planes a shard), in
float32 from the port's parameters (the MulResUnet body bridged by
``io/bridge.py``, the glue mapped here) and the JAX run's canvas, with no
per-step noise. ``JCaller`` is the flax twin of tests/test_torch_spatial_
custom.py's ``Caller``: a MulResUnet child, ``nn.Conv``, a spatial mean into
``nn.Dense``, an average pool and ``jax.image.resize`` (the port's
``blocks.upsample``). The first 5 losses agree to rtol 1e-3, as
tests/test_torch_spatial_zoo_jax_options.py holds the zoo nets."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deep_prior_interpolation_tpu.models as J
from deep_prior_interpolation_tpu.config import Config as JaxConfig
from deep_prior_interpolation_tpu.engine import DIPSolver as JaxDIPSolver
from deep_prior_interpolation_tpu.parallel import make_spatial_mesh as jax_make_spatial_mesh
from deep_prior_interpolation_tpu_torch import Config, DIPSolver
from deep_prior_interpolation_tpu_torch.io import state_dict_to_jax_params
from deep_prior_interpolation_tpu_torch.models import init_weights
from deep_prior_interpolation_tpu_torch.parallel import make_spatial_mesh
from test_torch_spatial_custom import Caller, _patch

torch.set_num_threads(1)
KW = dict(datadim="2d", epochs=6, inputdepth=4, filters=[8, 16], skip=[4], scan_chunk=6,
          gain=1.0, reg_noise_std=0.0, dtype="float32", upsample="linear")


class JCaller(fnn.Module):
    """The flax twin of the port's ``Caller`` (channels-last)."""

    body: fnn.Module

    @fnn.compact
    def __call__(self, x):
        h = fnn.leaky_relu(fnn.Conv(4, (3, 3), padding=1, name="pre")(x), 0.2)
        g = fnn.sigmoid(fnn.Dense(4, name="gate")(jnp.mean(h, axis=(1, 2))))
        h = fnn.avg_pool(h * g[:, None, None, :], (2, 2), strides=(2, 2))
        n, hh, ww, c = h.shape
        h = jax.image.resize(h, (n, 2 * hh, 2 * ww, c), "bilinear")
        scale = self.param("scale", fnn.initializers.constant(0.5), ())
        return self.body(x) + scale * fnn.Conv(1, (1, 1), name="head")(h)


def _jax_params(state):
    """The port's state dict as ``JCaller``'s tree: the body through the
    bridge, the torch convs' (O, I, kh, kw) as (kh, kw, I, O), the
    ``Linear``'s (out, in) as (in, out)."""
    sd = {k: v.detach().numpy() for k, v in state.items()}

    def conv(name):
        return {"kernel": np.transpose(sd[f"{name}.weight"], (2, 3, 1, 0)),
                "bias": sd[f"{name}.bias"]}
    return {"body": state_dict_to_jax_params({k[5:]: v for k, v in state.items()
                                              if k.startswith("body.")}),
            "pre": conv("pre"), "head": conv("head"),
            "gate": {"kernel": sd["gate.weight"].T, "bias": sd["gate.bias"]},
            "scale": np.asarray(sd["scale"], np.float32)}


@pytest.fixture(scope="module")
def solves():
    img, mask = _patch(24, 32)
    torch.manual_seed(0)
    port = DIPSolver(Config(**KW), device="cpu", model=Caller(Config(**KW)))
    init_weights(port.model, torch.Generator().manual_seed(0), "xavier", 0.02)
    init = {k: v.clone() for k, v in port.model.state_dict().items()}
    jcfg = JaxConfig(**KW)
    ref = JaxDIPSolver(jcfg, outchannel=1, model=JCaller(body=J.get_net(jcfg, 1))).solve(
        img, mask, seed=0, init_params=_jax_params(init),
        spatial_mesh=jax_make_spatial_mesh(8), spatial_axis=1)
    canvas = np.asarray(ref.noise, np.float32)
    got = port.solve(img, mask, seed=0, init_params=init, noise=canvas,
                     spatial_mesh=make_spatial_mesh(8, [torch.device("cpu")] * 8),
                     spatial_axis=1)
    return ref, got, canvas


def test_the_sharded_solve_of_a_callers_module_follows_the_jax_one(solves):
    ref, got, _ = solves
    np.testing.assert_allclose(got.history.loss[:5], ref.history.loss[:5], rtol=1e-3)
    assert got.iters_run == ref.iters_run == 6


def test_its_canvas_and_output(solves):
    ref, got, canvas = solves
    np.testing.assert_array_equal(got.noise, canvas)
    assert got.out_best.shape == np.asarray(ref.out_best).shape
    assert np.all(np.isfinite(got.out_best))
