"""The port's patch batch (parallel/mesh.py) against the JAX package's
``solve_patches_batched`` on the CPU: the JAX batch's own per-lane
parameters and canvases (from its ``setup_patch_batch``, bridged by
``io/bridge.py``) go into the port's batch, with no per-step input noise
(``reg_noise_std=0``: the two packages draw different random numbers), and
each lane's first losses, iterations and stop agree. The tiny 2D config of
tests/test_parallel.py."""
import jax
import numpy as np
import torch

from deep_prior_interpolation_tpu.config import Config as JaxConfig
from deep_prior_interpolation_tpu.engine import DIPSolver as JaxDIPSolver
from deep_prior_interpolation_tpu.engine import StepSettings as JaxStepSettings
from deep_prior_interpolation_tpu.engine import pad_multiple_for as jax_pad_multiple_for
from deep_prior_interpolation_tpu.engine import padded_spatial as jax_padded_spatial
from deep_prior_interpolation_tpu.parallel import setup_patch_batch as jax_setup_patch_batch
from deep_prior_interpolation_tpu.parallel import \
    solve_patches_batched as jax_solve_patches_batched
from deep_prior_interpolation_tpu_torch import Config, DIPSolver
from deep_prior_interpolation_tpu_torch.io import jax_params_to_state_dict
from deep_prior_interpolation_tpu_torch.parallel import solve_patches_batched

torch.set_num_threads(1)
KW = dict(datadim="2d", epochs=10, inputdepth=4, filters=[8, 16], skip=[4], scan_chunk=5,
          gain=1.0, reg_noise_std=0.0, earlystop_patience=3, earlystop_min_delta=2.0)


def make_patches(n, nt=24, nx=16):
    rng = np.random.RandomState(0)
    t = np.linspace(0, 1, nt)[:, None]
    x = np.linspace(0, 1, nx)[None, :]
    out = []
    for i in range(n):
        img = np.sin(2 * np.pi * ((2 + i) * t + 2 * x)).astype(np.float32)[..., None]
        mask = np.repeat((rng.rand(1, nx) > 0.5).astype(np.float32), nt, 0)[..., None]
        out.append({"image": img, "mask": mask, "name": str(i)})
    return out


def test_port_batch_follows_the_jax_batch():
    patches = make_patches(3)
    jc = JaxConfig(**KW)
    jsolver = JaxDIPSolver(jc, outchannel=1)
    spatial = tuple(patches[0]["image"].shape[:-1])
    padded = jax_padded_spatial(spatial, jax_pad_multiple_for(jc))
    input_shape = (1,) + padded + (jc.inputdepth,)
    s = JaxStepSettings.from_config(jc, spatial, input_shape=input_shape)
    carry, data = jax_setup_patch_batch(jc, jsolver, s,
                                        np.stack([p["image"] for p in patches]),
                                        np.stack([p["mask"] for p in patches]),
                                        padded, input_shape)
    port = DIPSolver(Config(**KW), device="cpu")
    like = port.model.state_dict()
    inits = [jax_params_to_state_dict(
        jax.tree_util.tree_map(lambda a, b=b: np.asarray(a[b]), carry["params"]["net"]), like)
        for b in range(3)]
    canvases = [np.asarray(data["base_input"][b, 0], np.float32) for b in range(3)]
    ref = jax_solve_patches_batched(jc, jsolver, patches)
    got = solve_patches_batched(Config(**KW), port, patches, init_params=inits,
                                noises=canvases)
    assert len(got) == len(ref) == 3
    for g, r, c in zip(got, ref, canvases):
        np.testing.assert_allclose(g.history.loss[:5], r.history.loss[:5], rtol=1e-3)
        assert g.iters_run == r.iters_run and g.stopped_early == r.stopped_early
        assert len(g.history.loss) == len(r.history.loss) == g.iters_run
        np.testing.assert_array_equal(g.noise, np.asarray(r.noise, np.float32))
        assert g.out_best.shape == r.out_best.shape and np.all(np.isfinite(g.out_best))
