"""A mesh of the devices there are (parallel/mesh.py ``make_mesh``,
parallel/spatial.py ``make_spatial_mesh``; ROADMAP A.13e), as the JAX
package's ``devs[:n]`` takes them: more devices asked for than exist give
those that exist and a warning naming the cut; a ``devices`` list shorter
than asked is taken whole; with no CUDA device (and none given) the mesh
raises and never falls back to the CPU; ``[cuda:0] * N`` stays the way to
run N shards on one card. ``torch.cuda.device_count`` is monkeypatched.
The CLI passes on the mesh it built and logs its true size, and a
one-shard spatial layout (what ``--spatial_shards 2`` builds on one card)
solves as the unsharded solver does."""
import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu_torch import Config, DIPSolver, cli, parallel
from deep_prior_interpolation_tpu_torch.data import dataset_path
from deep_prior_interpolation_tpu_torch.io import completed_patches
from deep_prior_interpolation_tpu_torch.parallel import make_mesh, make_spatial_mesh

torch.set_num_threads(1)
CPU = torch.device("cpu")
MAKERS = {"make_mesh": make_mesh, "make_spatial_mesh": make_spatial_mesh}


def cards(monkeypatch, n: int) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: n > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)


@pytest.mark.parametrize("name", list(MAKERS))
def test_more_cards_asked_for_than_exist_give_those_that_exist(name, monkeypatch):
    cards(monkeypatch, 2)
    with pytest.warns(RuntimeWarning, match="3 devices asked for, 2 exist: the mesh takes 2"):
        mesh = MAKERS[name](3)
    assert mesh == [torch.device("cuda", 0), torch.device("cuda", 1)]
    cards(monkeypatch, 1)
    with pytest.warns(RuntimeWarning, match="4 devices asked for, 1 exist: the mesh takes 1"):
        assert MAKERS[name](4) == [torch.device("cuda", 0)]


@pytest.mark.parametrize("name", list(MAKERS))
def test_a_shorter_devices_list_is_taken_whole(name):
    devices = [CPU] * 3
    with pytest.warns(RuntimeWarning, match="5 devices asked for, 3 given: the mesh takes 3"):
        assert MAKERS[name](5, devices) == devices
    assert MAKERS[name](0, devices) == devices


@pytest.mark.parametrize("name", list(MAKERS))
def test_no_cuda_device_raises_and_never_gives_a_cpu_mesh(name, monkeypatch):
    cards(monkeypatch, 0)
    for n in (0, 1, 4):
        with pytest.raises(RuntimeError, match="no CUDA device exists"):
            MAKERS[name](n)


def test_one_card_repeated_stays_n_shards(recwarn, monkeypatch):
    cards(monkeypatch, 1)
    card = [torch.device("cuda", 0)] * 4
    assert make_spatial_mesh(4, card) == card and make_mesh(4, card) == card
    assert make_spatial_mesh(2) == [torch.device("cuda", 0)]   # with the warning
    assert [str(w.message) for w in recwarn] == ["2 devices asked for, 1 exist: the mesh "
                                                "takes 1"]


def _patch(nt=16, nx=24):
    rng = np.random.RandomState(0)
    t = np.linspace(0, 1, nt)[:, None]
    x = np.linspace(0, 1, nx)[None, :]
    img = np.sin(2 * np.pi * (3 * t + 2 * x)).astype(np.float32)[..., None]
    mask = np.repeat((rng.rand(1, nx) > 0.5).astype(np.float32), nt, 0)[..., None]
    return img, mask


@pytest.mark.parametrize("net", ["multiunet", "skip"])
def test_a_one_shard_layout_solves_as_the_unsharded_solver(net):
    """A mesh of one device (``--spatial_shards 2`` on one card) walks the
    net over one shard: the halos are the zero padding, the sums the
    whole volume's, so the solve is the unsharded one to rounding."""
    c = Config(datadim="2d", epochs=3, scan_chunk=3, inputdepth=4, gain=1.0, filters=[8, 16],
               skip=[4], net=net)
    img, mask = _patch()
    ref = DIPSolver(c, device="cpu").solve(img, mask, seed=0)
    got = DIPSolver(c, device="cpu").solve(img, mask, seed=0, spatial_mesh=[CPU])
    np.testing.assert_allclose(got.history.loss, ref.history.loss, rtol=1e-5)
    np.testing.assert_allclose(got.out_best, ref.out_best, rtol=0,
                               atol=1e-5 * float(np.abs(ref.out_best).max()))


def _lines_cfg(**kw):
    import os
    return Config(datadim="2d", epochs=2, inputdepth=4, filters=[8, 16], skip=[4],
                  scan_chunk=2, gain=1.0,
                  imgdir=os.path.dirname(dataset_path("lines/original.npy")),
                  imgname="original.npy", maskname="random66.npy", **kw)


@pytest.mark.parametrize("kw,maker,log", [
    (dict(spatial_shards=2), "make_spatial_mesh", "each patch over 1 devices along spatial"),
    (dict(batch_patches=2, mesh_shape=2), "make_mesh", "each group's lanes over 1 devices"),
])
def test_the_cli_runs_on_the_mesh_it_built(kw, maker, log, tmp_path, monkeypatch, capsys):
    """A mesh cut to one device (as on a one-card machine): the CLI logs
    its true size, solves on it and writes the patch's bundle."""
    real = getattr(parallel, maker)
    monkeypatch.setattr(parallel, maker, lambda n, devices=None: real(1, devices))
    out = cli.run(_lines_cfg(outdir="run", **kw), str(tmp_path), device="cpu")
    assert completed_patches(out) == ["0"]
    assert log in capsys.readouterr().out
