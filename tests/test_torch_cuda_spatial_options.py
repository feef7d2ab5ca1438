"""The solver's options over spatial shards (parallel/spatial.py) on a CUDA
card, with the kernels: each option's sharded solve over ``[cuda:0] * 2``
against the unsharded card solve at a small size (float32, TF32 off, the
fused loss, ``DPI_PALLAS_WGRAD=1``, trilinear upsampling), first 3 losses
rtol 1e-4 as the CPU tests hold them; every shard launches each kernel;
remat over the shards is bit-equal to the same solve without it and
launches the same kernels as often (it recomputes forwards only).

Imports only torch and the port, so it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda_spatial_options.py -q

Every test skips without a CUDA card (the kernels have no CPU mode); the
CPU tests hold the same options against the unsharded port and the JAX
package (tests/test_torch_spatial_{options,pocs,jax_options}.py)."""
import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu_torch import Config, DIPSolver
from deep_prior_interpolation_tpu_torch.ops import fused_loss as FL
from deep_prior_interpolation_tpu_torch.ops import upsample as U
from deep_prior_interpolation_tpu_torch.ops import wgrad as WG

torch.set_num_threads(1)


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    monkeypatch.setenv("DPI_PALLAS_WGRAD", "1")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    yield torch.device("cuda:0")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def volume():
    rng = np.random.RandomState(1)
    t = np.linspace(0, 1, 16)[:, None, None]
    x = np.linspace(0, 1, 16)[None, :, None]
    y = np.linspace(0, 1, 16)[None, None, :]
    img = np.sin(2 * np.pi * (2 * t + x + y)).astype(np.float32)[..., None]
    mask = np.repeat((rng.rand(1, 16, 16) > 0.4).astype(np.float32), 16, 0)[..., None]
    return img, mask


def cfg(**kw):
    return Config(**{**dict(datadim="3d", inputdepth=4, filters=[4, 8, 16], skip=[4, 4],
                            upsample="linear", epochs=3, scan_chunk=3, gain=1.0,
                            fused_loss=True, dtype="float32"), **kw})


def counts():
    return (FL.fused_sums.launches, FL.loss_sums_grad.launches, WG.wgrad3d.launches,
            U.upsample_bwd.launches)


def launched(fn):
    """``fn()`` and the launches of each kernel it made."""
    before = counts()
    out = fn()
    return out, tuple(a - b for a, b in zip(counts(), before))


@pytest.mark.parametrize("kw", [
    dict(param_noise=True), dict(lowpass_fs=250.0, lowpass_fc=40.0),
    dict(data_forgetting_factor=3), dict(virtual_input=True), dict(dropout=0.1),
    dict(pocs=True), dict(pocs=True, data_forgetting_factor=3, remat=True, dropout=0.1)])
def test_each_option_over_two_shards_of_the_card(cuda, kw):
    img, mask = volume()
    c = cfg(**kw)
    ref = DIPSolver(c, device=cuda).solve(img, mask, seed=0)
    got, n = launched(lambda: DIPSolver(c, device=cuda).solve(
        img, mask, seed=0, spatial_mesh=[cuda] * 2))
    fields = ("loss", "df", "reg", "eps") if c.pocs else ("loss",)
    for f in fields:
        np.testing.assert_allclose(getattr(got.history, f), getattr(ref.history, f),
                                   rtol=1e-4, err_msg=f)
    assert np.all(np.isfinite(got.out_best)) and got.out_best.shape == img.shape
    # each kernel once a shard where the unsharded step launches it once
    # (fused loss forward and backward; the 2 linear upsamples' backward)
    assert n[0] == n[1] == 2 * 3 and n[3] == 2 * 2 * 3 and n[2] > 0
    np.testing.assert_array_equal(got.noise, ref.noise)


def test_remat_over_the_shards_is_bit_equal_and_launches_as_often(cuda, tmp_path):
    img, mask = volume()
    runs = {}
    for name, extra in (("plain", {}), ("remat", dict(remat=True))):
        c = cfg(dropout=0.1, param_noise=True, epochs=4, scan_chunk=2, **extra)
        runs[name] = launched(lambda: DIPSolver(c, device=cuda).solve(
            img, mask, seed=0, spatial_mesh=[cuda] * 2,
            checkpoint_path=str(tmp_path / name), checkpoint_every=1))
    (plain, n_plain), (remat, n_remat) = runs["plain"], runs["remat"]
    assert n_plain == n_remat
    np.testing.assert_array_equal(remat.history.loss, plain.history.loss)
    np.testing.assert_array_equal(remat.out_best, plain.out_best)


def test_a_sharded_resume_with_every_draw_is_bit_equal(cuda, tmp_path):
    img, mask = volume()
    kw = dict(dropout=0.1, param_noise=True, remat=True, data_forgetting_factor=3,
              scan_chunk=2)
    mesh = [cuda] * 4

    def run(name, epochs):
        return DIPSolver(cfg(epochs=epochs, **kw), device=cuda).solve(
            img, mask, seed=0, spatial_mesh=mesh, checkpoint_path=str(tmp_path / name),
            checkpoint_every=1)
    straight = run("a", 4)
    run("b", 2)
    resumed = run("b", 4)
    assert resumed.iters_run == 4
    np.testing.assert_array_equal(resumed.history.loss, straight.history.loss)
    np.testing.assert_array_equal(resumed.out_best, straight.out_best)
