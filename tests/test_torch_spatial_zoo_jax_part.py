"""The port's sharded partial-conv U-Net solve against the JAX package's
sharded solve on its 8 virtual CPU devices (tests/conftest.py): the JAX
``DIPSolver.solve`` with ``spatial_mesh=make_spatial_mesh(8)`` (GSPMD
partitions the step) and the port's over ``[cpu] * 2`` (its walk, whose
shards hold whole 32-plane blocks of the net's five stride-2 steps), of
a 2D ``--net part`` in float32 (the only dtype either package runs it in)
from the port's parameters (bridged by ``io/bridge.py``) and the JAX run's
canvas, with no per-step noise (``reg_noise_std=0``: the packages draw
different random numbers). The mask goes into the net through the
solver's ``net_mask``, split as the canvas is. The first 5 losses agree to
rtol 1e-3, as tests/test_torch_spatial_jax_options.py holds the options.
One JAX solve, of a (32, 64) patch along axis 1."""
import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu.config import Config as JaxConfig
from deep_prior_interpolation_tpu.engine import DIPSolver as JaxDIPSolver
from deep_prior_interpolation_tpu.parallel import make_spatial_mesh as jax_make_spatial_mesh
from deep_prior_interpolation_tpu_torch import Config, DIPSolver
from deep_prior_interpolation_tpu_torch.io import state_dict_to_jax_params
from deep_prior_interpolation_tpu_torch.models import init_weights
from deep_prior_interpolation_tpu_torch.parallel import make_spatial_mesh

torch.set_num_threads(1)
KW = dict(datadim="2d", epochs=6, inputdepth=4, filters=[8, 16], skip=[4], scan_chunk=6,
          gain=1.0, reg_noise_std=0.0, dtype="float32", net="part")


def one_patch(nt=32, nx=64):
    rng = np.random.RandomState(0)
    t = np.linspace(0, 1, nt)[:, None]
    x = np.linspace(0, 1, nx)[None, :]
    img = np.sin(2 * np.pi * (3 * t + 2 * x)).astype(np.float32)[..., None]
    mask = np.repeat((rng.rand(1, nx) > 0.5).astype(np.float32), nt, 0)[..., None]
    return img, mask


@pytest.fixture(scope="module")
def solves():
    img, mask = one_patch()
    port = DIPSolver(Config(**KW), device="cpu")
    init_weights(port.model, torch.Generator().manual_seed(0), "xavier", 0.02)
    init = {k: v.clone() for k, v in port.model.state_dict().items()}
    ref = JaxDIPSolver(JaxConfig(**KW), outchannel=1).solve(
        img, mask, seed=0, init_params=state_dict_to_jax_params(init),
        spatial_mesh=jax_make_spatial_mesh(8), spatial_axis=1)
    canvas = np.asarray(ref.noise, np.float32)
    got = port.solve(img, mask, seed=0, init_params=init, noise=canvas,
                     spatial_mesh=make_spatial_mesh(2, [torch.device("cpu")] * 2),
                     spatial_axis=1)
    return ref, got, canvas


def test_the_sharded_partial_conv_solve_follows_the_jax_one(solves):
    ref, got, _ = solves
    np.testing.assert_allclose(got.history.loss[:5], ref.history.loss[:5], rtol=1e-3)
    assert got.iters_run == ref.iters_run == 6


def test_its_canvas_and_output(solves):
    ref, got, canvas = solves
    np.testing.assert_array_equal(got.noise, canvas)
    assert got.out_best.shape == np.asarray(ref.out_best).shape
    assert np.all(np.isfinite(got.out_best))
