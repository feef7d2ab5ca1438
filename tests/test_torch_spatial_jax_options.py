"""The port's sharded POCS solve with data forgetting against the JAX
package's sharded solve on its 8 virtual CPU devices (tests/conftest.py):
the JAX ``DIPSolver.solve`` with ``spatial_mesh=make_spatial_mesh(8)`` and
the port's over ``[cpu] * 8``, both in float32 from the port's parameters
(bridged by ``io/bridge.py``) and the JAX run's canvas, with options that
draw no random numbers (``reg_noise_std=0``; the forgetting term and the
adaptive POCS weight are functions of the data and the output). The first
5 losses and POCS terms agree to rtol 1e-3. One JAX solve, of a (24, 64)
patch: of a (24, 32) patch over 8 shards along axis 1 (4 planes a shard)
XLA's partitioned FFT aborts the JAX compile (``fft_handler.cc``:
"size_per_partition % num_partitions == 0")."""
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
          gain=1.0, reg_noise_std=0.0, pocs=True, data_forgetting_factor=4, dtype="float32")


def one_patch(nt=24, nx=64):
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
                     spatial_mesh=make_spatial_mesh(8, [torch.device("cpu")] * 8),
                     spatial_axis=1)
    return ref, got, canvas


def test_the_sharded_pocs_and_forgetting_solve_follows_the_jax_one(solves):
    ref, got, _ = solves
    np.testing.assert_allclose(got.history.loss[:5], ref.history.loss[:5], rtol=1e-3)
    for f in ("df", "reg", "eps"):
        np.testing.assert_allclose(getattr(got.history, f)[:5], getattr(ref.history, f)[:5],
                                   rtol=1e-3, err_msg=f)
    assert got.iters_run == ref.iters_run == 6


def test_its_canvas_output_and_projection(solves):
    ref, got, canvas = solves
    np.testing.assert_array_equal(got.noise, canvas)
    for a, b in ((got.out_best, ref.out_best), (got.pocs, ref.pocs)):
        assert a.shape == np.asarray(b).shape and np.all(np.isfinite(a))
