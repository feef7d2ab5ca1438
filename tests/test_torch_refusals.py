"""What the port refuses: a sharded axis shorter than the mesh, a weights
file that is not msgpack and a canvas of the wrong shape are rejected; the
solver options, nets and conv formulations it serves (phase space, tapmm
and the zoo nets over shards, on whole blocks of the net or not, and a
module of the caller's own that rolls along the sharded axis, among them)
build and run."""
import os

import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu_torch import Config, DIPSolver, cli
from deep_prior_interpolation_tpu_torch.data import dataset_path
from deep_prior_interpolation_tpu_torch.io import completed_patches, load_params
from deep_prior_interpolation_tpu_torch.models import Conv

torch.set_num_threads(1)
LINES = os.path.dirname(dataset_path("lines/original.npy"))


def tiny_cfg(**kw):
    base = dict(datadim="2d", epochs=2, inputdepth=4, filters=[8, 16], skip=[4],
                scan_chunk=2, gain=1.0)
    base.update(kw)
    return Config(**base)


def lines_cfg(**kw):
    """``tiny_cfg`` on the bundled lines gather, (170, 100, 1) in one patch."""
    return tiny_cfg(imgdir=LINES, imgname="original.npy", maskname="random66.npy", **kw)


@pytest.mark.parametrize("kw", [dict(spatial_shards=2, net="skip")])
def test_unported_features_raise(kw, tmp_path):
    """What a sharded CLI run refused before the zoo walks (ROADMAP A.13c
    item 11) runs: ``cli.run`` of a sharded skip net on the lines gather
    (100 planes along axis 1: 25 of its 4-plane blocks) writes its bundle."""
    out = cli.run(lines_cfg(outdir="run", **kw), str(tmp_path), device="cpu")
    assert completed_patches(out) == ["0"]


class Mine(torch.nn.Module):
    """A module of the caller's own: one library conv, its output rolled by
    one plane along the last dim."""

    def __init__(self):
        super().__init__()
        self.conv = Conv(4, 1, 3)

    def forward(self, x):
        return torch.roll(self.conv(x), 1, dims=-1)


def test_cli_and_weights_refusals(tmp_path):
    """A sharded ``--net part`` run (with tapmm, which the shards serve) on
    the lines gather, padded to the JAX package's multiple of 2, which was
    refused before uneven shards (its 100 planes along axis 1 are not whole
    32-plane blocks of the net's five stride-2 steps), runs and writes its
    bundle, its shards on 4-plane blocks; a module of the caller's own
    that rolls along the sharded axis, which the sharded walker refused
    before its relayouts, runs with an optimised canvas (which the shards
    serve) and follows its unsharded solve; a mesh longer than the
    sharded axis's blocks runs, one longer than the axis is a ValueError; a
    weights file that is not msgpack is refused with its offset."""
    out = cli.run(lines_cfg(spatial_shards=2, batch_patches=0, vmap_conv_mode="tapmm",
                            net="part", outdir="part"), str(tmp_path), device="cpu")
    assert completed_patches(out) == ["0"]
    img = np.random.RandomState(0).randn(16, 8, 1).astype(np.float32)
    mesh = [torch.device("cpu")] * 2
    rolled = [DIPSolver(tiny_cfg(opt_over="net,input"), device="cpu", model=Mine()).solve(
        img, np.ones_like(img), seed=0, spatial_mesh=m) for m in (None, mesh)]
    np.testing.assert_allclose(rolled[1].history.loss, rolled[0].history.loss, rtol=1e-5)
    assert rolled[1].out_best.shape == img.shape and rolled[1].whole_ops == []
    res = DIPSolver(tiny_cfg(), device="cpu").solve(img, np.ones_like(img),
                                                    spatial_mesh=mesh * 4)
    assert np.all(np.isfinite(res.history.loss)) and res.out_best.shape == img.shape
    with pytest.raises(ValueError, match="8 planes is shorter than the mesh of 9 shards"):
        DIPSolver(tiny_cfg(), device="cpu").solve(img, img, spatial_mesh=mesh * 4 + mesh[:1])
    bad = tmp_path / "weights.msgpack"
    bad.write_bytes(b"\xc1")  # the one byte msgpack never uses
    with pytest.raises(ValueError, match="offset 0"):
        load_params(str(bad))


@pytest.mark.parametrize("kw", [
    dict(param_noise=True), dict(data_forgetting_factor=5), dict(dropout=0.1),
    dict(opt_over="net,input"), dict(virtual_input=True), dict(remat=True),
    dict(filter_noise_with_wavelet=True), dict(lowpass_fs=250.0, lowpass_fc=40.0),
    dict(net="part"), dict(net="unet", filters=[4, 8, 8, 8, 8], skip=[4, 4, 4, 4]),
    dict(net="skip"), dict(net="attmultiunet"), dict(phase_space=True),
    dict(vmap_conv_mode="tapmm"),
])
def test_served_features_build(kw):
    solver = DIPSolver(tiny_cfg(**kw), device="cpu")
    assert sum(p.numel() for p in solver.model.parameters()) > 0


def test_solve_refuses_a_wrong_canvas():
    img = np.zeros((32, 24, 1), np.float32)
    with pytest.raises(ValueError, match="noise"):
        DIPSolver(tiny_cfg(), device="cpu").solve(
            img, np.ones_like(img), noise=np.zeros((3, 3, 4), np.float32))
