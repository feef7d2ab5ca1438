"""The port's CLI (cli.py, io/results.py) on the bundled lines data
with a tiny net, on the CPU, against the JAX package's bundle format, run
manifest and reconstruction.

The reconstruction of the port's run directory by either package sums the
same float32 outputs over the same index map; XLA on the CPU flushes
subnormal results to zero where torch keeps them, so the two agree to
float32's smallest normal number (``SUBNORMAL``)."""
import os

import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu import config as jcfg
from deep_prior_interpolation_tpu.data import reconstruct_patches as jax_reconstruct
from deep_prior_interpolation_tpu.engine.history import HistoryPOCS as JaxHistoryPOCS
from deep_prior_interpolation_tpu.io.results import save_run as jax_save_run
from deep_prior_interpolation_tpu_torch import cli
from deep_prior_interpolation_tpu_torch.config import parse_arguments, read_args
from deep_prior_interpolation_tpu_torch.data import dataset_path, reconstruct_patches
from deep_prior_interpolation_tpu_torch.engine import DIPSolver
from deep_prior_interpolation_tpu_torch.io import completed_patches, load_run

torch.set_num_threads(1)
SUBNORMAL = dict(rtol=0, atol=float(np.finfo(np.float32).tiny))
LINES = os.path.dirname(dataset_path("lines/original.npy"))


def _cfg(outdir, *flags):
    """The README's command on the lines data, cut to a tiny net and two
    (170, 50, 1) patches."""
    return parse_arguments([
        "--imgdir", LINES, "--imgname", "original.npy", "--maskname", "random66.npy",
        "--datadim", "2d", "--gain", "1", "--outdir", outdir, "--epochs", "4",
        "--scan_chunk", "2", "--inputdepth", "4", "--filters", "4", "8", "--skip", "4",
        "--patch_shape", "170", "50", "1", *flags])


@pytest.fixture(scope="module")
def pocs_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("runs"))
    cfg = _cfg("pocs", "--pocs", "--save_every", "2", "--savemodel")
    return cfg, root, cli.run(cfg, root, device="cpu")


def test_run_writes_bundles_snapshots_and_weights(pocs_run):
    cfg, _, out = pocs_run
    names = completed_patches(out)
    assert names == ["0", "1"]
    files = set(os.listdir(out))
    for n in names:
        assert {f"{n}_run.npz", f"{n}_output2.npy", f"{n}_model.pt"} <= files
        b = load_run(os.path.join(out, f"{n}_run.npz"))
        assert b["device"] == "cpu" and b["output"].shape == (170, 50, 1)
        assert set(b["history"]) == set(JaxHistoryPOCS.FIELDS)
        assert all(len(v) == 4 and np.all(np.isfinite(v)) for v in b["history"].values())
        assert np.load(os.path.join(out, f"{n}_output2.npy")).shape == (170, 50, 1)


def test_bundle_keys_match_the_jax_bundle(pocs_run, tmp_path):
    _, _, out = pocs_run
    b = load_run(os.path.join(out, "0_run.npz"))
    jpath = jax_save_run(str(tmp_path), "0", JaxHistoryPOCS(4), b["mask"], b["image"],
                         b["output"], elapsed=1.0, noise=b["noise"], pocs=b["pocs"])
    with np.load(jpath, allow_pickle=True) as z:
        jax_keys = list(z.files)
    with np.load(os.path.join(out, "0_run.npz"), allow_pickle=True) as z:
        assert list(z.files) == jax_keys
        for k in jax_keys:
            assert z[k].dtype.kind == np.load(jpath, allow_pickle=True)[k].dtype.kind, k


def test_jax_reconstructs_the_ports_run_directory(pocs_run):
    cfg, _, out = pocs_run
    got = reconstruct_patches(cfg, results_dir=out)
    want = jax_reconstruct(jcfg.Config.from_dict(cfg.to_dict()), results_dir=out)
    assert got.shape == (170, 100, 1) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, **SUBNORMAL)


def test_args_txt_is_read_back_by_both_packages(pocs_run):
    cfg, _, out = pocs_run
    path = os.path.join(out, "args.txt")
    assert read_args(path).to_dict() == cfg.to_dict()
    assert jcfg.read_args(path).to_dict() == cfg.to_dict()


def test_rerun_skips_the_finished_patches(pocs_run, monkeypatch):
    cfg, root, out = pocs_run
    before = {n: os.path.getmtime(os.path.join(out, f"{n}_run.npz")) for n in ("0", "1")}

    def no_solve(*a, **k):
        raise AssertionError("a finished patch was solved again")
    monkeypatch.setattr(DIPSolver, "solve", no_solve)
    assert cli.run(cfg, root, device="cpu") == out
    assert before == {n: os.path.getmtime(os.path.join(out, f"{n}_run.npz")) for n in before}


def test_an_all_corrupted_patch_is_skipped_as_img_times_mask(tmp_path):
    img = np.load(os.path.join(LINES, "original.npy")).astype(np.float32)
    mask = np.load(os.path.join(LINES, "random66.npy")).astype(np.float32)
    mask[:, 50:] = 0.0  # the second patch has no trace left
    out = cli.run(_cfg("zero"), str(tmp_path), original=img, corrupted=mask, device="cpu")
    b = load_run(os.path.join(out, "1_run.npz"))
    np.testing.assert_array_equal(b["output"], b["image"] * b["mask"])
    assert not np.any(b["output"]) and b["history"]["loss"] == []
    assert "noise" not in b and load_run(os.path.join(out, "0_run.npz"))["history"]["loss"]


def test_netdir_and_start_from_prev_load_the_weights(pocs_run, tmp_path):
    _, root, _ = pocs_run
    seen = []
    real = DIPSolver.solve

    def spy(self, *a, **k):
        seen.append(k.get("init_params"))
        return real(self, *a, **k)
    mp = pytest.MonkeyPatch()
    mp.setattr(DIPSolver, "solve", spy)
    try:
        cli.run(_cfg("tl", "--pocs", "--net", "load", "--netdir", "pocs/0_model.pt"), root,
                device="cpu")
        cli.run(_cfg("prev", "--start_from_prev"), str(tmp_path), device="cpu")
    finally:
        mp.undo()
    saved = torch.load(os.path.join(root, "pocs", "0_model.pt"))
    assert all(torch.equal(seen[0][k], v) for k, v in saved.items())
    assert seen[2] is None and seen[3] is not None  # patch 1 starts from patch 0


def test_refusals_and_the_device(monkeypatch, tmp_path):
    # --spatial_shards 2 solves each patch over two CPU shards: the bundles
    # of an unsharded run, but for the order of the shards' sums
    sharded = cli.run(_cfg("s", "--spatial_shards", "2"), str(tmp_path), device="cpu")
    plain = cli.run(_cfg("u"), str(tmp_path), device="cpu")
    assert completed_patches(sharded) == completed_patches(plain) == ["0", "1"]
    for n in ("0", "1"):
        s, p = (load_run(os.path.join(d, f"{n}_run.npz")) for d in (sharded, plain))
        assert list(s) == list(p)
        for k in ("image", "mask", "noise"):
            np.testing.assert_array_equal(s[k], p[k])
        np.testing.assert_allclose(s["history"]["loss"], p["history"]["loss"], rtol=1e-4)
        np.testing.assert_allclose(s["output"], p["output"], rtol=0,
                                   atol=1e-4 * float(np.abs(p["output"]).max()))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.run(_cfg("nocuda"), str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--imgdir", LINES, "--imgname", "original.npy",
                  "--maskname", "random66.npy"])
    assert not os.path.exists(tmp_path / "nocuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert cli.run_device(_cfg("g", "--gpu", "3")) == torch.device("cuda:0")
    assert cli.run_device(_cfg("g", "--gpu", "0")) == torch.device("cuda:0")
    assert cli.run_device(_cfg("g")) == torch.device("cuda")
