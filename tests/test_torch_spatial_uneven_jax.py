"""The port's sharded solves on shards that do not lie on the net's blocks
against the JAX package's sharded solves on its 8 virtual CPU devices
(tests/conftest.py), where GSPMD shards unevenly: the JAX
``DIPSolver.solve`` with ``spatial_mesh=make_spatial_mesh(N)`` and the
port's over ``[cpu] * N``, in float32 from the port's parameters (bridged
by ``io/bridge.py``) and the JAX run's canvas, with no per-step noise
(``reg_noise_std=0``). The first 5 losses agree to rtol 1e-3, as
tests/test_torch_spatial_zoo_jax_options.py holds them.

Two JAX solves of a (48, 40) patch padded to (48, 48): the skip net of
five filters (32-plane blocks) over 2 shards along axis 0, which the port
splits at 32 and 48 (its deepest level of 2 planes on 1 and 1), and the
U-Net (16-plane blocks) over 4 shards along axis 1, 3 blocks of the axis,
which the port splits on 8-plane blocks (its deepest level of 3 planes on
1, 1, 1 and none). Both packages take the devices there are: a mesh of 16
asked for over 8 gives 8."""
import jax
import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu.config import Config as JaxConfig
from deep_prior_interpolation_tpu.engine import DIPSolver as JaxDIPSolver
from deep_prior_interpolation_tpu.engine import build_base_input as jax_build_base_input
from deep_prior_interpolation_tpu.parallel import make_spatial_mesh as jax_make_spatial_mesh
from deep_prior_interpolation_tpu_torch import Config, DIPSolver
from deep_prior_interpolation_tpu_torch.io import state_dict_to_jax_params
from deep_prior_interpolation_tpu_torch.models import init_weights
from deep_prior_interpolation_tpu_torch.parallel import make_spatial_mesh

torch.set_num_threads(1)
CPU = torch.device("cpu")
KW = dict(datadim="2d", epochs=6, inputdepth=4, filters=[4, 4, 4, 4, 4], skip=[2, 2, 2, 2],
          scan_chunk=6, gain=1.0, reg_noise_std=0.0, dtype="float32")
# each case: the net, the shards, the sharded axis
CASES = {"skip": ("skip", 2, 0), "unet": ("unet", 4, 1)}


def one_patch(nt=48, nx=40):
    rng = np.random.RandomState(0)
    t = np.linspace(0, 1, nt)[:, None]
    x = np.linspace(0, 1, nx)[None, :]
    img = np.sin(2 * np.pi * (3 * t + 2 * x)).astype(np.float32)[..., None]
    mask = np.repeat((rng.rand(1, nx) > 0.5).astype(np.float32), nt, 0)[..., None]
    return img, mask


@pytest.fixture(scope="module", params=list(CASES))
def solves(request):
    net, n, axis = CASES[request.param]
    img, mask = one_patch()
    kw = {**KW, "net": net}
    port = DIPSolver(Config(**kw), device="cpu")
    init_weights(port.model, torch.Generator().manual_seed(0), "xavier", 0.02)
    init = {k: v.clone() for k, v in port.model.state_dict().items()}
    ref = JaxDIPSolver(JaxConfig(**kw), outchannel=1).solve(
        img, mask, seed=0, init_params=state_dict_to_jax_params(init),
        spatial_mesh=jax_make_spatial_mesh(n), spatial_axis=axis)
    # the JAX run's canvas at the padded shape, drawn from its seed's key
    k_noise = jax.random.split(jax.random.PRNGKey(0), 3)[0]
    canvas = np.asarray(jax_build_base_input(JaxConfig(**kw), k_noise, (48, 48)))[0]
    got = port.solve(img, mask, seed=0, init_params=init, noise=canvas,
                     spatial_mesh=make_spatial_mesh(n, [CPU] * n), spatial_axis=axis)
    return ref, got, canvas


def test_the_uneven_sharded_solve_follows_the_jax_one(solves):
    ref, got, _ = solves
    np.testing.assert_allclose(got.history.loss[:5], ref.history.loss[:5], rtol=1e-3)
    assert got.iters_run == ref.iters_run == 6


def test_its_canvas_and_output(solves):
    ref, got, canvas = solves
    np.testing.assert_array_equal(got.noise, np.asarray(ref.noise))
    np.testing.assert_array_equal(got.noise, canvas[:, 4:44])
    assert got.out_best.shape == np.asarray(ref.out_best).shape
    assert np.all(np.isfinite(got.out_best))


def test_both_packages_take_the_devices_there_are():
    assert jax_make_spatial_mesh(16).devices.size == 8
    with pytest.warns(RuntimeWarning, match="16 devices asked for, 8 given: the mesh takes 8"):
        assert len(make_spatial_mesh(16, [CPU] * 8)) == 8
