"""The port's spatially sharded solve (``DIPSolver.solve(spatial_mesh=...)``)
against its unsharded solve on the CPU, with the JAX package's
tests/test_spatial.py configurations on ``[cpu] * 8`` (its 8 virtual CPU
devices).

Both solves draw the same parameters, canvas and noise from one seed; the
shards sum the Norm statistics, the weight gradients and the loss in
another order, so the first 3 losses agree to rtol 1e-4 (measured: 1e-7;
the JAX test holds its sharded solve to 1e-3) and the trajectories part
later, as Adam's sign-like first steps amplify rounding. A sharded resume
from a checkpoint, which holds whole tensors, is bit-equal to the straight
sharded solve."""
import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu_torch import Config, DIPSolver
from deep_prior_interpolation_tpu_torch.parallel import make_spatial_mesh

torch.set_num_threads(1)
MESH = make_spatial_mesh(8, [torch.device("cpu")] * 8)


def one_patch(nt=24, nx=32):
    rng = np.random.RandomState(0)
    t = np.linspace(0, 1, nt)[:, None]
    x = np.linspace(0, 1, nx)[None, :]
    img = np.sin(2 * np.pi * (3 * t + 2 * x)).astype(np.float32)[..., None]
    mask = np.repeat((rng.rand(1, nx) > 0.5).astype(np.float32), nt, 0)[..., None]
    return img, mask


def volume():
    rng = np.random.RandomState(1)
    nt, nx, ny = 16, 16, 8
    t = np.linspace(0, 1, nt)[:, None, None]
    x = np.linspace(0, 1, nx)[None, :, None]
    y = np.linspace(0, 1, ny)[None, None, :]
    img = np.sin(2 * np.pi * (2 * t + x + y)).astype(np.float32)[..., None]
    mask = np.repeat((rng.rand(1, nx, ny) > 0.4).astype(np.float32), nt, 0)[..., None]
    return img, mask


def cfg(**kw):
    base = dict(datadim="2d", epochs=10, inputdepth=4, filters=[8, 16], skip=[4], scan_chunk=5,
                gain=1.0)
    base.update(kw)
    return Config(**base)


def both(c, img, mask, mesh=MESH, axis=1, **kw):
    seq = DIPSolver(c, device="cpu").solve(img, mask, seed=0, **kw)
    shd = DIPSolver(c, device="cpu").solve(img, mask, seed=0, spatial_mesh=mesh,
                                           spatial_axis=axis, **kw)
    return seq, shd


def test_the_sharded_2d_solve_follows_the_unsharded_one():
    img, mask = one_patch()
    seq, shd = both(cfg(), img, mask)
    np.testing.assert_allclose(shd.history.loss[:3], seq.history.loss[:3], rtol=1e-4)
    assert abs(shd.history.loss[-1] - seq.history.loss[-1]) < 0.5 * seq.history.loss[0]
    assert shd.iters_run == seq.iters_run == 10
    assert shd.out_best.shape == seq.out_best.shape == img.shape
    np.testing.assert_allclose(shd.out_best, seq.out_best,
                               atol=0.5 * float(np.abs(seq.out_best).max()))
    np.testing.assert_array_equal(shd.noise, seq.noise)
    assert shd.params.keys() == seq.params.keys()


@pytest.mark.parametrize("upsample", ["linear", "nearest"])
def test_the_sharded_3d_solve_follows_the_unsharded_one(upsample):
    c = Config(datadim="3d", epochs=6, scan_chunk=3, inputdepth=4, filters=[8, 16], skip=[4],
               gain=1.0, upsample=upsample)
    img, mask = volume()
    seq, shd = both(c, img, mask)
    np.testing.assert_allclose(shd.history.loss[:3], seq.history.loss[:3], rtol=1e-4)
    assert shd.out_best.shape == img.shape and np.all(np.isfinite(shd.out_best))
    assert np.all(np.isfinite(shd.history.loss))


def test_a_padded_patch_over_uneven_shards_with_snapshots_and_the_plain_loss():
    # (22, 30) padded to (24, 32) by a net of 2 downsamplings: 8 blocks of
    # 4 columns over 3 shards; the crop takes a column off each end shard
    img, mask = one_patch(22, 30)
    c = cfg(filters=[8, 16, 32], skip=[4, 4], epochs=6, scan_chunk=3, save_every=3,
            loss="mse")
    seq, shd = both(c, img, mask, mesh=make_spatial_mesh(3, [torch.device("cpu")] * 3))
    np.testing.assert_allclose(shd.history.loss[:3], seq.history.loss[:3], rtol=1e-4)
    for f in ("snr", "pcorr"):
        np.testing.assert_allclose(getattr(shd.history, f)[:3], getattr(seq.history, f)[:3],
                                   rtol=1e-4)
    assert shd.snapshots.keys() == seq.snapshots.keys() == {3}
    np.testing.assert_allclose(shd.snapshots[3], seq.snapshots[3], rtol=1e-3, atol=1e-4)
    assert shd.out_best.shape == img.shape


def test_the_fused_loss_in_bfloat16_along_the_first_axis():
    img, mask = volume()
    c = Config(datadim="3d", epochs=4, scan_chunk=2, inputdepth=4, filters=[8, 16], skip=[4],
               gain=1.0, upsample="linear", dtype="bfloat16", fused_loss=True)
    seq, shd = both(c, img, mask, mesh=make_spatial_mesh(4, [torch.device("cpu")] * 4), axis=0)
    # iteration 0 sees one forward: the same bf16 net but for the Norm sums
    np.testing.assert_allclose(shd.history.loss[0], seq.history.loss[0], rtol=1e-5)
    assert np.all(np.isfinite(shd.history.loss)) and shd.iters_run == 4


def test_given_weights_and_canvas_go_through_the_shards():
    img, mask = one_patch()
    c = cfg(reg_noise_std=0.0, epochs=4, scan_chunk=2)
    model = DIPSolver(c, device="cpu").model
    from deep_prior_interpolation_tpu_torch.models import init_weights
    init_weights(model, torch.Generator().manual_seed(5), "xavier", 0.02)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    noise = (0.1 * np.random.RandomState(3).randn(24, 32, 4)).astype(np.float32)
    seq, shd = both(c, img, mask, init_params=init, noise=noise)
    np.testing.assert_allclose(shd.history.loss[:3], seq.history.loss[:3], rtol=1e-4)
    np.testing.assert_array_equal(shd.noise, noise)


def test_a_sharded_resume_is_bit_equal_to_the_straight_run(tmp_path):
    img, mask = one_patch()
    ckpt = str(tmp_path / "state")
    kw = dict(seed=0, spatial_mesh=MESH, spatial_axis=1)
    full = DIPSolver(cfg(epochs=8, scan_chunk=2), device="cpu").solve(img, mask, **kw)
    DIPSolver(cfg(epochs=4, scan_chunk=2), device="cpu").solve(
        img, mask, checkpoint_path=ckpt, checkpoint_every=1, **kw)
    with np.load(ckpt + ".npz") as z:   # whole tensors, as an unsharded checkpoint holds
        assert z["out_best"].shape == (1, 1, 24, 32)
    res = DIPSolver(cfg(epochs=8, scan_chunk=2), device="cpu").solve(
        img, mask, checkpoint_path=ckpt, checkpoint_every=1, **kw)
    assert res.iters_run == full.iters_run == 8
    np.testing.assert_array_equal(res.history.loss, full.history.loss)
    np.testing.assert_array_equal(res.out_best, full.out_best)
