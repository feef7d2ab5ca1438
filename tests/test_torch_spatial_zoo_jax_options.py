"""The port's sharded solves of the zoo's remaining constructor options
against the JAX package's sharded solves on its 8 virtual CPU devices
(tests/conftest.py): the JAX ``DIPSolver(model=...).solve`` with
``spatial_mesh=make_spatial_mesh(8)`` and the port's over ``[cpu] * 8``,
in float32 from the port's parameters (bridged by ``io/bridge.py``) and
the JAX run's canvas, with no per-step noise (``reg_noise_std=0``), along
axis 1. The first 5 losses agree to rtol 1e-3, as
tests/test_torch_spatial_zoo_jax_attention.py holds the attention net.

Two JAX solves: a 2D skip net with reflection padding, ``lanczos2`` then
``lanczos3`` downsampling and bilinear upsampling on a (24, 32) patch (4
planes a shard; the ``lanczos3`` halo of 5 planes reaches over 2-plane
shards at level 1), and a 2D U-Net with its deconv up path and
``more_layers=1`` on a (32, 256) patch (its 32-plane blocks, one a shard,
a plane a shard at its deepest level)."""
import numpy as np
import pytest
import torch

import deep_prior_interpolation_tpu.models as J
from deep_prior_interpolation_tpu.config import Config as JaxConfig
from deep_prior_interpolation_tpu.engine import DIPSolver as JaxDIPSolver
from deep_prior_interpolation_tpu.parallel import make_spatial_mesh as jax_make_spatial_mesh
from deep_prior_interpolation_tpu_torch import Config, DIPSolver
from deep_prior_interpolation_tpu_torch.io import state_dict_to_jax_params
from deep_prior_interpolation_tpu_torch.models import SkipNet, UNet, init_weights
from deep_prior_interpolation_tpu_torch.parallel import make_spatial_mesh

torch.set_num_threads(1)
KW = dict(datadim="2d", epochs=6, inputdepth=4, filters=[8, 16], skip=[4], scan_chunk=6,
          gain=1.0, reg_noise_std=0.0, dtype="float32")
SKIP = dict(filters=(8, 16), skip=(4,), pad="reflection",
            downsample_mode=["lanczos2", "lanczos3"], upsample_mode="bilinear")
UNET = dict(filters=(4, 4, 4, 4, 4), upsample_mode="deconv", more_layers=1)
# each case: the JAX net, the port's, the patch, extra configuration
CASES = {
    "skip": (lambda: J.SkipNet(out_channels=1, ndim=2, **SKIP),
             lambda: SkipNet(4, 1, 2, **SKIP), (24, 32), {}),
    "unet": (lambda: J.UNet(out_channels=1, ndim=2, **UNET),
             lambda: UNet(4, 1, 2, **UNET), (32, 256), {"pad_multiple": 32}),
}


def one_patch(nt, nx):
    rng = np.random.RandomState(0)
    t = np.linspace(0, 1, nt)[:, None]
    x = np.linspace(0, 1, nx)[None, :]
    img = np.sin(2 * np.pi * (3 * t + 2 * x)).astype(np.float32)[..., None]
    mask = np.repeat((rng.rand(1, nx) > 0.5).astype(np.float32), nt, 0)[..., None]
    return img, mask


@pytest.fixture(scope="module", params=list(CASES))
def solves(request):
    jax_net, port_net, shape, extra = CASES[request.param]
    img, mask = one_patch(*shape)
    kw = {**KW, **extra}
    port = DIPSolver(Config(**kw), device="cpu", model=port_net())
    init_weights(port.model, torch.Generator().manual_seed(0), "xavier", 0.02)
    init = {k: v.clone() for k, v in port.model.state_dict().items()}
    ref = JaxDIPSolver(JaxConfig(**kw), outchannel=1, model=jax_net()).solve(
        img, mask, seed=0, init_params=state_dict_to_jax_params(init),
        spatial_mesh=jax_make_spatial_mesh(8), spatial_axis=1)
    canvas = np.asarray(ref.noise, np.float32)
    got = port.solve(img, mask, seed=0, init_params=init, noise=canvas,
                     spatial_mesh=make_spatial_mesh(8, [torch.device("cpu")] * 8),
                     spatial_axis=1)
    return ref, got, canvas


def test_the_sharded_solve_follows_the_jax_one(solves):
    ref, got, _ = solves
    np.testing.assert_allclose(got.history.loss[:5], ref.history.loss[:5], rtol=1e-3)
    assert got.iters_run == ref.iters_run == 6


def test_its_canvas_and_output(solves):
    ref, got, canvas = solves
    np.testing.assert_array_equal(got.noise, canvas)
    assert got.out_best.shape == np.asarray(ref.out_best).shape
    assert np.all(np.isfinite(got.out_best))
