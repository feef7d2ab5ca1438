"""What the port refuses: every feature it does not serve yet (what a
spatially sharded solve does not cover, ROADMAP A.13c: the zoo nets)
raises NotImplementedError naming its ROADMAP item, and a canvas of the
wrong shape is rejected; the solver options, nets and conv formulations it
serves (phase space and tapmm among them) build."""
import os

import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu_torch import Config, DIPSolver, cli
from deep_prior_interpolation_tpu_torch.io import load_params

torch.set_num_threads(1)


def tiny_cfg(**kw):
    base = dict(datadim="2d", epochs=2, inputdepth=4, filters=[8, 16], skip=[4],
                scan_chunk=2, gain=1.0)
    base.update(kw)
    return Config(**base)


@pytest.mark.parametrize("kw", [dict(spatial_shards=2, net="skip")])
def test_unported_features_raise(kw, tmp_path):
    """Spatial shards are the CLI's (a library solve ignores the field, as
    the JAX one does); ``cli.run`` refuses a sharded run of what the shards
    do not cover yet before it solves a patch."""
    with pytest.raises(NotImplementedError, match="ROADMAP A.13c"):
        cli.run(tiny_cfg(**kw), str(tmp_path), device="cpu")
    assert not os.listdir(tmp_path)


def test_cli_and_weights_refusals(tmp_path):
    """A sharded run of a zoo net, through the CLI (with tapmm, which the
    shards serve), and a solve of another given a spatial mesh (with an
    optimised canvas, which they serve) are refused naming ROADMAP A.13c;
    a mesh longer than the sharded axis's blocks is a ValueError; a weights
    file that is not msgpack is refused with its offset."""
    with pytest.raises(NotImplementedError, match=r"--net part: ROADMAP A.13c"):
        cli.run(tiny_cfg(spatial_shards=2, batch_patches=0, vmap_conv_mode="tapmm",
                         net="part"), str(tmp_path), device="cpu")
    img = np.zeros((16, 8, 1), np.float32)
    mesh = [torch.device("cpu")] * 2
    with pytest.raises(NotImplementedError, match=r"--net attmultiunet: ROADMAP A.13c"):
        DIPSolver(tiny_cfg(opt_over="net,input", net="attmultiunet"),
                  device="cpu").solve(img, img, spatial_mesh=mesh)
    with pytest.raises(ValueError, match="at most 4 shards"):
        DIPSolver(tiny_cfg(), device="cpu").solve(img, img, spatial_mesh=mesh * 4)
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
