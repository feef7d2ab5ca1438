"""The port's plots (utils/plotting.py) and post-run report
(io/report.show_results) on the Agg backend, against the JAX package's:
the same images, extents and GIF bytes, and the same summary of a run
directory, the port's and the JAX package's (SNR and Pearson at rtol
1e-6)."""
import os

import numpy as np
import pytest
import torch

import deep_prior_interpolation_tpu.utils.plotting as JP
from deep_prior_interpolation_tpu import config as jcfg
from deep_prior_interpolation_tpu.data import extract_patches as jax_extract
from deep_prior_interpolation_tpu.engine.history import History as JaxHistory
from deep_prior_interpolation_tpu.io import save_run as jax_save_run
from deep_prior_interpolation_tpu.io import show_results as jax_show_results
from deep_prior_interpolation_tpu_torch import cli
from deep_prior_interpolation_tpu_torch.config import parse_arguments
from deep_prior_interpolation_tpu_torch.data import dataset_path
from deep_prior_interpolation_tpu_torch.io import report, show_results
from deep_prior_interpolation_tpu_torch.utils import plotting as PP

torch.set_num_threads(1)
LINES = os.path.dirname(dataset_path("lines/original.npy"))
FLAGS = ["--imgdir", LINES, "--imgname", "original.npy", "--maskname", "random66.npy",
         "--datadim", "2d", "--gain", "1", "--epochs", "3", "--scan_chunk", "3",
         "--inputdepth", "4", "--filters", "4", "8", "--skip", "4",
         "--patch_shape", "170", "50", "1"]


def _images(fig):
    return [(np.asarray(im.get_array()), im.get_extent(), im.get_clim())
            for ax in fig.axes for im in ax.images]


def test_clim_gather_and_volume_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    g = rng.randn(32, 16).astype(np.float32)
    vol = rng.randn(16, 12, 10).astype(np.float32)
    assert PP.clim(g, 95) == JP.clim(g, 95)
    pairs = [(PP.plot_gather(g, tlim=(0, 2), filename=str(tmp_path / "g.png")),
              JP.plot_gather(g, tlim=(0, 2))),
             (PP.explode_volume(vol, t=3, xlim=(0, 1), filename=str(tmp_path / "v")),
              JP.explode_volume(vol, t=3, xlim=(0, 1)))]
    for got, want in pairs:
        a, b = _images(got), _images(want)
        assert len(a) == len(b) > 0
        for (ia, ea, ca), (ib, eb, cb) in zip(a, b):
            np.testing.assert_array_equal(ia, ib)
            assert ea == eb and ca == cb
    assert os.path.exists(tmp_path / "g.png") and os.path.exists(tmp_path / "v.png")


def test_gif_and_wiggles_match_jax(tmp_path):
    rng = np.random.RandomState(1)
    vol = rng.randn(5, 16, 12).astype(np.float32)
    PP.gif_from_array(vol, str(tmp_path / "p.gif"), axis=1)
    JP.gif_from_array(vol, str(tmp_path / "j.gif"), axis=1)
    assert (tmp_path / "p.gif").read_bytes() == (tmp_path / "j.gif").read_bytes()
    with pytest.raises(ValueError, match="dimension"):
        PP.gif_from_array(vol, str(tmp_path / "x.gif"), axis=3)
    plt = PP._pyplot()
    fig, (a, b) = plt.subplots(1, 2)
    g = rng.randn(64, 8).astype(np.float32)
    PP.seismograms(g, a, gain=0.5, color=("red", "blue"))
    JP.seismograms(g, b, gain=0.5, color=("red", "blue"))
    assert len(a.collections) == len(b.collections) == 16
    assert list(a.get_xticks()) == list(b.get_xticks()) and a.get_ylim() == b.get_ylim()
    with pytest.raises(ValueError, match="tuple of 2"):
        PP.seismograms(g, a, color=("red",))
    plt.close("all")


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    """A port run directory (a tiny CPU run) and a JAX one (bundles written
    by the JAX package's own ``save_run``) of the lines data."""
    root = str(tmp_path_factory.mktemp("results"))
    port = cli.run(parse_arguments(FLAGS + ["--outdir", "port"]), root, device="cpu")
    cfg = jcfg.parse_arguments(FLAGS + ["--outdir", "jax"])
    jax_dir = os.path.join(root, "jax")
    jcfg.write_args(os.path.join(jax_dir, "args.txt"), cfg)
    rng = np.random.RandomState(2)
    for p in jax_extract(cfg):
        hist = JaxHistory(3)
        hist.extend({"loss": rng.rand(3), "snr": rng.rand(3), "pcorr": rng.rand(3),
                     "lr": np.full(3, 1e-3)}, 3)
        out = p["image"] + 0.05 * rng.randn(*p["image"].shape).astype(np.float32)
        jax_save_run(jax_dir, p["name"], hist, p["mask"], p["image"], out, elapsed=1.0)
    return port, jax_dir


@pytest.mark.parametrize("which", [0, 1])
def test_show_results_reads_either_packages_run(run_dirs, which):
    res_dir = run_dirs[which]
    got, summary = show_results(res_dir, curves=1, savefig=True)
    want, jax_summary = jax_show_results(res_dir)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (170, 100, 1) and summary["n_patches"] == jax_summary["n_patches"] == 2
    for k in ("snr", "pcorr"):
        np.testing.assert_allclose(summary[k], jax_summary[k], rtol=1e-6)
    assert os.path.exists(os.path.join(res_dir, "curves.png"))
    assert os.path.exists(os.path.join(res_dir, "output.png"))
    PP._pyplot().close("all")


def test_show_results_without_matplotlib_returns_the_summary(run_dirs, monkeypatch):
    # a card's machine may lack matplotlib: the report is computed, no figure drawn
    want, want_summary = show_results(run_dirs[0])

    def missing():
        raise ImportError("No module named 'matplotlib'")
    monkeypatch.setattr(report, "_pyplot", missing)
    got, summary = show_results(run_dirs[0], curves=1)
    np.testing.assert_array_equal(got, want)
    assert summary == want_summary
    PP._pyplot().close("all")
