"""POCS over spatial shards (parallel/spatial.py, ROADMAP A.13c item 7)
against the unsharded solve on the CPU, and ``cli.run --spatial_shards 2
--pocs`` end to end.

The sharded step gathers the cropped output shards to the solver's device
(``SpatialLayout.gather``, whose backward splits the gradient), runs the
unsharded ``pocs_term`` there on the whole volume and adds ``eps * reg`` to
the loss the shards' sums give; the final projection reads the gathered
best output. Held as the other options are (tests/test_torch_spatial_options.py):
3 iterations, losses and the POCS terms (df, reg, eps, th) rtol 1e-4, the
best output and its projection within 1e-4 of their max."""
import os

import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu_torch import Config, DIPSolver, cli
from deep_prior_interpolation_tpu_torch.config import parse_arguments
from deep_prior_interpolation_tpu_torch.data import dataset_path
from deep_prior_interpolation_tpu_torch.io import completed_patches, load_run
from deep_prior_interpolation_tpu_torch.parallel.spatial import SpatialLayout

torch.set_num_threads(1)
CPU = torch.device("cpu")
TERMS = ("loss", "df", "reg", "eps", "th", "snr", "pcorr")


def one_patch():
    rng = np.random.RandomState(0)
    t = np.linspace(0, 1, 24)[:, None]
    x = np.linspace(0, 1, 32)[None, :]
    img = np.sin(2 * np.pi * (3 * t + 2 * x)).astype(np.float32)[..., None]
    mask = np.repeat((rng.rand(1, 32) > 0.5).astype(np.float32), 24, 0)[..., None]
    return img, mask


def volume():
    rng = np.random.RandomState(1)
    t = np.linspace(0, 1, 16)[:, None, None]
    x = np.linspace(0, 1, 16)[None, :, None]
    y = np.linspace(0, 1, 8)[None, None, :]
    img = np.sin(2 * np.pi * (2 * t + x + y)).astype(np.float32)[..., None]
    mask = np.repeat((rng.rand(1, 16, 8) > 0.4).astype(np.float32), 16, 0)[..., None]
    return img, mask


PROBLEMS = {
    "2d": (one_patch, dict(datadim="2d", inputdepth=4, filters=[8, 16, 32], skip=[4, 4],
                           gain=1.0)),
    "3d": (volume, dict(datadim="3d", inputdepth=4, filters=[4, 8], skip=[4], gain=1.0,
                        upsample="linear")),
}


def held(dim, shards=(2, 4), axis=1, **kw):
    c = Config(**{**PROBLEMS[dim][1], "epochs": 3, "scan_chunk": 3, "pocs": True, **kw})
    img, mask = PROBLEMS[dim][0]()
    ref = DIPSolver(c, device="cpu").solve(img, mask, seed=0)
    for n in shards:
        got = DIPSolver(c, device="cpu").solve(img, mask, seed=0, spatial_mesh=[CPU] * n,
                                               spatial_axis=axis)
        for f in TERMS:
            np.testing.assert_allclose(getattr(got.history, f), getattr(ref.history, f),
                                       rtol=1e-4, err_msg=f)
        for a, b in ((got.out_best, ref.out_best), (got.pocs, ref.pocs)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * float(np.abs(b).max()))
    return ref


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_adaptive_pocs_over_the_shards_follows_the_unsharded_solve(dim):
    ref = held(dim)
    assert ref.pocs.shape == ref.out_best.shape and np.all(np.asarray(ref.history.eps) > 0)


@pytest.mark.parametrize("kw", [dict(pocs_eps_mode="attached"), dict(pocs_weight=0.5),
                                dict(data_forgetting_factor=3, remat=True, dropout=0.1)])
def test_pocs_with_its_weights_and_the_other_options(kw):
    ref = held("3d", shards=(2,), axis=0, **kw)
    if "pocs_weight" in kw:
        np.testing.assert_array_equal(ref.history.eps, 0.5)


def test_the_gather_s_backward_splits_the_gradient():
    torch.manual_seed(0)
    x = torch.randn(1, 2, 8, 12, dtype=torch.float64)
    layout = SpatialLayout([CPU] * 3, 1, (8, 12), (8, 12), 2)
    shards = [t.requires_grad_() for t in layout.split(x)]
    whole = layout.gather(shards)
    torch.testing.assert_close(whole, x, rtol=0, atol=0)
    g = torch.randn_like(x)
    grads = torch.autograd.grad(whole, shards, g)
    torch.testing.assert_close(torch.cat(grads, 3), g, rtol=0, atol=0)
    assert [t.shape[3] for t in grads] == [4, 4, 4]


LINES = dataset_path("lines")


def _cfg(outdir, *flags):
    return parse_arguments([
        "--imgdir", LINES, "--imgname", "original.npy", "--maskname", "random66.npy",
        "--datadim", "2d", "--gain", "1", "--outdir", outdir, "--epochs", "3",
        "--scan_chunk", "3", "--filters", "8", "16", "--skip", "4", "--inputdepth", "4",
        "--patch_shape", "170", "48", "--pocs", "--savemodel", *flags])


def test_the_cli_runs_a_sharded_pocs_survey(tmp_path):
    sharded = cli.run(_cfg("s", "--spatial_shards", "2"), str(tmp_path), device="cpu")
    plain = cli.run(_cfg("u"), str(tmp_path), device="cpu")
    names = completed_patches(plain)
    assert completed_patches(sharded) == names and len(names) >= 2
    for n in names:
        s, p = (load_run(os.path.join(d, f"{n}_run.npz")) for d in (sharded, plain))
        assert list(s) == list(p) and set(s["history"]) == set(p["history"])
        for k in ("image", "mask", "noise"):
            np.testing.assert_array_equal(s[k], p[k])
        for f in ("loss", "df", "reg", "eps"):
            np.testing.assert_allclose(s["history"][f], p["history"][f], rtol=1e-4)
        for k in ("output", "pocs"):
            np.testing.assert_allclose(s[k], p[k], rtol=0,
                                       atol=1e-4 * float(np.abs(p[k]).max()))
        assert os.path.exists(os.path.join(sharded, f"{n}_model.msgpack"))
