"""Two behaviours of the JAX package that the port now shares.

* ``--batch_patches N --start_from_prev``: the JAX ``cli.run`` batches only
  without ``start_from_prev``, else it solves the patches one after another,
  each from the previous patch's weights. The port's and the JAX run of the
  same tiny 2D problem, with no per-step input noise, each solve handed the
  same weights and canvas (JAX draws the canvases; the port's solve of a
  later patch gets its previous patch's weights from the port's run, checked,
  and starts from the JAX run's, which differ from them by rounding only):
  same patches, same bundle keys, losses at rtol 1e-4.
* ``Config(spatial_shards=N)``: a library solve reads only its
  ``spatial_mesh`` argument and solves on one device; only the CLI builds a
  mesh from the field, so only ``cli.run`` refuses it."""
import os

import jax
import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu import cli as jax_cli
from deep_prior_interpolation_tpu import config as jcfg
from deep_prior_interpolation_tpu.engine import DIPSolver as JaxDIPSolver
from deep_prior_interpolation_tpu_torch import Config, DIPSolver, cli
from deep_prior_interpolation_tpu_torch.config import parse_arguments
from deep_prior_interpolation_tpu_torch.data import dataset_path
from deep_prior_interpolation_tpu_torch.io import (jax_params_to_state_dict, load_run,
                                                   state_dict_to_jax_params)
from deep_prior_interpolation_tpu_torch.models import init_weights

torch.set_num_threads(1)
LINES = os.path.dirname(dataset_path("lines/original.npy"))
FLAGS = ["--imgdir", LINES, "--imgname", "original.npy", "--maskname", "random66.npy",
         "--datadim", "2d", "--gain", "1", "--epochs", "4", "--scan_chunk", "2",
         "--inputdepth", "4", "--filters", "4", "8", "--skip", "4", "--reg_noise_std", "0",
         "--patch_shape", "170", "50", "1", "--batch_patches", "2", "--start_from_prev"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX and the port's run of FLAGS, and the solves' results."""
    root = str(tmp_path_factory.mktemp("runs"))
    cfg = parse_arguments(FLAGS + ["--outdir", "port"])
    model = DIPSolver(cfg, device="cpu").model
    init_weights(model, torch.Generator().manual_seed(0), "xavier", 0.02)
    init = {k: v.clone() for k, v in model.state_dict().items()}

    jax_res, port_res = [], []
    real_jax, real_port = JaxDIPSolver.solve, DIPSolver.solve

    def jax_spy(self, img, mask, seed=0, init_params=None, **k):
        if init_params is None:  # the first patch: the port's weights
            init_params = state_dict_to_jax_params(init)
        kept = jax.tree_util.tree_map(np.array, init_params)  # the solve donates its input
        jax_res.append((seed, kept,
                        real_jax(self, img, mask, seed=seed, init_params=init_params, **k)))
        return jax_res[-1][2]

    def port_spy(self, img, mask, seed=0, init_params=None, **k):
        i = len(port_res)
        start = jax_params_to_state_dict(jax_res[i][1])
        port_res.append((seed, init_params, real_port(self, img, mask, seed=seed,
                                                      init_params=start,
                                                      noise=jax_res[i][2].noise, **k)))
        return port_res[-1][2]
    mp = pytest.MonkeyPatch()
    mp.setattr(JaxDIPSolver, "solve", jax_spy)
    mp.setattr(DIPSolver, "solve", port_spy)
    try:
        jax_out = jax_cli.run(jcfg.parse_arguments(FLAGS + ["--outdir", "jax"]), root)
        port_out = cli.run(cfg, root, device="cpu")
    finally:
        mp.undo()
    return jax_out, port_out, jax_res, port_res


def test_start_from_prev_with_batch_patches_runs_patch_after_patch(runs):
    jax_out, port_out, jax_res, port_res = runs
    assert [s for s, _, _ in jax_res] == [s for s, _, _ in port_res] == [0, 1]
    for name in ("0", "1"):
        with np.load(os.path.join(jax_out, f"{name}_run.npz"), allow_pickle=True) as j, \
                np.load(os.path.join(port_out, f"{name}_run.npz"), allow_pickle=True) as p:
            assert list(p.files) == list(j.files)
            for k in ("image", "mask"):
                np.testing.assert_array_equal(p[k], j[k])
        jl = load_run(os.path.join(jax_out, f"{name}_run.npz"))["history"]["loss"]
        pl = load_run(os.path.join(port_out, f"{name}_run.npz"))["history"]["loss"]
        assert len(pl) == len(jl) == 4
        np.testing.assert_allclose(pl, jl, rtol=1e-4)


def test_the_second_patch_starts_from_the_first_ones_weights(runs):
    _, _, jax_res, port_res = runs
    (_, given0, p0), (_, given1, _) = port_res
    assert given0 is None and given1 is p0.params  # the port's run handed them on
    # and they are the JAX run's patch-0 weights but for rounding: Adam moves
    # a parameter by about lr a step, a parameter whose gradient is rounding
    # noise (a conv bias before a Norm) by +-lr in either package
    want = jax_params_to_state_dict(jax_res[1][1])
    for k, v in want.items():
        torch.testing.assert_close(given1[k], v, rtol=0, atol=2 * 4 * 1e-3)


def test_spatial_shards_is_the_clis_field(tmp_path):
    rng = np.random.RandomState(0)
    img = rng.randn(24, 16, 1).astype(np.float32)
    mask = (rng.rand(1, 16, 1) > 0.5).astype(np.float32).repeat(24, 0)
    kw = dict(datadim="2d", epochs=4, scan_chunk=2, inputdepth=4, filters=[8, 16],
              skip=[4], gain=1.0)
    plain = DIPSolver(Config(**kw), device="cpu").solve(img, mask, seed=0)
    sharded = DIPSolver(Config(**kw, spatial_shards=2), device="cpu").solve(img, mask, seed=0)
    np.testing.assert_array_equal(sharded.history.loss, plain.history.loss)
    np.testing.assert_array_equal(sharded.out_best, plain.out_best)
    with pytest.raises(NotImplementedError, match="ROADMAP A.13b"):
        cli.run(parse_arguments(FLAGS[:-3] + ["--spatial_shards", "2", "--outdir", "s"]),
                str(tmp_path), device="cpu")
    assert not os.path.exists(tmp_path / "s")
