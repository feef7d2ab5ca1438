"""``cli.run --batch_patches`` (and ``--mesh_shape`` over CPU shards) of the
port against the JAX package's CLI on the bundled lines data, on the CPU:
the same bundle keys, patch names and history lengths, snapshots and
models as the sequential run writes them, and a second run on the same
directory skips every patch."""
import os

import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu import cli as jax_cli
from deep_prior_interpolation_tpu import config as jcfg
from deep_prior_interpolation_tpu_torch import cli
from deep_prior_interpolation_tpu_torch.config import parse_arguments
from deep_prior_interpolation_tpu_torch.data import dataset_path
from deep_prior_interpolation_tpu_torch.io import completed_patches, load_run

torch.set_num_threads(1)
LINES = os.path.dirname(dataset_path("lines/original.npy"))
FLAGS = ["--imgdir", LINES, "--imgname", "original.npy", "--maskname", "random66.npy",
         "--datadim", "2d", "--gain", "1", "--epochs", "4", "--scan_chunk", "2",
         "--inputdepth", "4", "--filters", "4", "8", "--skip", "4",
         "--patch_shape", "170", "50", "1", "--batch_patches", "2", "--save_every", "2"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("runs"))
    port = cli.run(parse_arguments(FLAGS + ["--outdir", "port", "--savemodel"]), root,
                   device="cpu")
    mesh = cli.run(parse_arguments(FLAGS + ["--outdir", "mesh", "--mesh_shape", "2"]), root,
                   device="cpu")
    ref = jax_cli.run(jcfg.parse_arguments(FLAGS + ["--outdir", "jax"]), root)
    return root, port, mesh, ref


def _bundles(out):
    return {n: load_run(os.path.join(out, f"{n}_run.npz")) for n in completed_patches(out)}


@pytest.mark.parametrize("which", ["port", "mesh"])
def test_batched_run_writes_the_jax_runs_bundles(runs, which):
    root, port, mesh, ref = runs
    got, want = _bundles(port if which == "port" else mesh), _bundles(ref)
    assert sorted(got) == sorted(want) == ["0", "1"]
    for n in want:
        assert set(got[n]) == set(want[n])
        assert set(got[n]["history"]) == set(want[n]["history"])
        for k, v in want[n]["history"].items():
            assert len(got[n]["history"][k]) == len(v) == 4, k
        assert got[n]["output"].shape == want[n]["output"].shape == (170, 50, 1)
        assert np.all(np.isfinite(got[n]["output"]))
    files = set(os.listdir(port))
    assert {"0_output2.npy", "1_output2.npy", "0_model.msgpack", "1_model.msgpack"} <= files


def test_lanes_over_cpu_shards_solve_as_one_device(runs):
    """--mesh_shape 2 lays the two lanes over two CPU shards: each lane is
    the lane of the one-device batch (same seeds and draws; a shard's
    grouped convs have one group, so they round differently)."""
    _, port, mesh, _ = runs
    a, b = _bundles(port), _bundles(mesh)
    for n in a:
        np.testing.assert_allclose(a[n]["history"]["loss"], b[n]["history"]["loss"], rtol=1e-5)
        np.testing.assert_allclose(a[n]["output"], b[n]["output"], rtol=1e-3, atol=1e-5)


def test_a_second_run_skips_every_patch(runs, monkeypatch):
    root, port, _, _ = runs
    from deep_prior_interpolation_tpu_torch import parallel
    calls = []
    monkeypatch.setattr(parallel, "solve_patches_batched",
                        lambda *a, **k: calls.append(1) or [])
    before = {f: os.path.getmtime(os.path.join(port, f)) for f in os.listdir(port)
              if f.endswith("_run.npz")}
    assert cli.run(parse_arguments(FLAGS + ["--outdir", "port"]), root, device="cpu") == port
    assert not calls
    assert before == {f: os.path.getmtime(os.path.join(port, f)) for f in before}
