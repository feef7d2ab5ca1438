"""What the port's DIPSolver refuses: every feature it does not serve yet
raises NotImplementedError naming its ROADMAP item, and a canvas of the wrong
shape is rejected."""
import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu_torch import Config, DIPSolver

torch.set_num_threads(1)


def tiny_cfg(**kw):
    base = dict(datadim="2d", epochs=2, inputdepth=4, filters=[8, 16], skip=[4],
                scan_chunk=2, gain=1.0)
    base.update(kw)
    return Config(**base)


@pytest.mark.parametrize("kw", [
    dict(param_noise=True), dict(data_forgetting_factor=5), dict(dropout=0.1),
    dict(opt_over="net,input"), dict(virtual_input=True), dict(remat=True), dict(phase_space=True),
    dict(filter_noise_with_wavelet=True), dict(lowpass_fs=250.0, lowpass_fc=40.0),
    dict(spatial_shards=2), dict(net="part"), dict(net="unet"),
    dict(vmap_conv_mode="tapmm"),
])
def test_unported_features_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        DIPSolver(tiny_cfg(**kw), device="cpu")


def test_solve_refuses_a_wrong_canvas():
    img = np.zeros((32, 24, 1), np.float32)
    with pytest.raises(ValueError, match="noise"):
        DIPSolver(tiny_cfg(), device="cpu").solve(
            img, np.ones_like(img), noise=np.zeros((3, 3, 4), np.float32))
