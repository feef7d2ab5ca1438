"""The zoo's remaining constructor options over spatial shards
(parallel/spatial_zoo.py) on a CUDA card, with the kernels: each net, given
to the solver (``DIPSolver(model=...)``), solved over ``[cuda:0] * 2``
against its unsharded card solve at a small size (float32, TF32 off, the
fused loss, ``DPI_PALLAS_WGRAD=1``, one summation order: deterministic
cuDNN and the wgrad kernel's first candidate grid, as
tests/test_torch_cuda_spatial_zoo.py runs). The iteration-0 loss holds to
rtol 1e-5, the CBAM U-Net's and the ensemble's to 1e-4 (their float32
forwards amplify a one-ulp change of the canvas ~10^3-fold through Norms
of near-constant maps: the ensemble's sharded loss parted by 1.1e-5 on an
H100), and every shard launches each kernel where the unsharded step
launches it: the fused loss on every solve; the wgrad kernel on the 3D
nets' same-padded 3 x 3 x 3 convs (never on a reflection-padded conv,
which the plain net also leaves to cuDNN); the upsample kernel on every
linear upsample (the CBAM U-Net's bilinear ones among them).

Imports only torch and the port, so it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda_spatial_zoo_options.py -q

Every test skips without a CUDA card (the kernels have no CPU mode); the
CPU tests hold the same walks against the unsharded port and the JAX
package (tests/test_torch_spatial_zoo_options.py,
tests/test_torch_spatial_zoo_jax_options.py)."""
import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu_torch import Config, DIPSolver
from deep_prior_interpolation_tpu_torch.engine import solver as S
from deep_prior_interpolation_tpu_torch.models import AttentionUnet, Ensemble, SkipNet, UNet
from deep_prior_interpolation_tpu_torch.ops import fused_loss as FL
from deep_prior_interpolation_tpu_torch.ops import upsample as U
from deep_prior_interpolation_tpu_torch.ops import wgrad as WG

torch.set_num_threads(1)


def first_grid(x, dy, k):
    """The wgrad planner's first candidate grid for this shape, in place of
    the tuner's fastest: one summation order in every run."""
    pl = WG._plans(x.shape[1], dy.shape[1], *x.shape[2:], k, x.dtype == torch.bfloat16,
                   x.shape[0])[0]
    return pl, WG._args(pl, WG._aligned(x, dy), x.shape[0])


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    monkeypatch.setenv("DPI_PALLAS_WGRAD", "1")
    monkeypatch.setattr(WG, "_tune", first_grid)
    monkeypatch.setattr(WG, "_tuned", {})
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    # the launch counters count calls from Python, which a step replayed
    # from a one-device solve's CUDA graph does not make: the unsharded
    # reference steps eagerly (tests/test_torch_cuda_step_graph.py holds the
    # graphed solve against the eager one)
    monkeypatch.setattr(S, "_GRAPHS", False)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    yield torch.device("cuda:0")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def volume(nt, nx, ny):
    rng = np.random.RandomState(1)
    t = np.linspace(0, 1, nt)[:, None, None]
    x = np.linspace(0, 1, nx)[None, :, None]
    y = np.linspace(0, 1, ny)[None, None, :]
    img = np.sin(2 * np.pi * (2 * t + x + y)).astype(np.float32)[..., None]
    mask = np.repeat((rng.rand(1, nx, ny) > 0.4).astype(np.float32), nt, 0)[..., None]
    return img, mask


def patch(nt, nx):
    img, mask = volume(nt, nx, 1)
    return img[:, :, 0], mask[:, :, 0]


def counts():
    return (FL.fused_sums.launches, FL.loss_sums_grad.launches, WG.wgrad3d.launches,
            U.upsample_bwd.launches)


def launched(fn):
    before = counts()
    out = fn()
    return out, tuple(a - b for a, b in zip(counts(), before))


# each net, its datadim, its problem, which kernels its step must launch
# (wgrad, upsample_bwd), and the iteration-0 loss's rtol
NETS = {
    "skip_reflect_lanczos": (
        lambda: SkipNet(4, 1, 3, (4, 8), (4,), pad="reflection",
                        downsample_mode=["lanczos2", "lanczos3"], upsample_mode="trilinear"),
        "3d", lambda: volume(16, 16, 16), (False, True), 1e-5),
    "skip_lanczos": (
        lambda: SkipNet(4, 1, 3, (4, 8), (4,), downsample_mode="lanczos3",
                        upsample_mode="trilinear"),
        "3d", lambda: volume(16, 16, 16), (True, True), 1e-5),
    "unet_deconv_more_layers": (
        lambda: UNet(4, 1, 3, (2, 2, 2, 2, 2), more_layers=1, upsample_mode="deconv"),
        "3d", lambda: volume(32, 64, 32), (True, False), 1e-5),
    "unet_concat_x": (
        lambda: UNet(4, 1, 3, (8, 8, 8, 8, 8), concat_x=True, upsample_mode="trilinear"),
        "3d", lambda: volume(16, 32, 16), (True, True), 1e-5),
    "cbam_unet": (lambda: AttentionUnet(4), "2d", lambda: patch(16, 32), (False, True), 1e-4),
    "ensemble": (lambda: Ensemble(4, 1, num_frames=1, hidden=8), "2d", lambda: patch(32, 64),
                 (False, False), 1e-4),
}


@pytest.mark.parametrize("net", list(NETS))
def test_a_zoo_option_over_two_shards_of_the_card(cuda, net):
    make, dim, problem, (wgrad, ups), rtol = NETS[net]
    c = Config(datadim=dim, inputdepth=4, epochs=3, scan_chunk=3, gain=1.0, fused_loss=True,
               dtype="float32", filters=[4, 8], skip=[4])
    img, mask = problem()
    ref, n_ref = launched(lambda: DIPSolver(c, device=cuda, model=make()).solve(
        img, mask, seed=0))
    got, n = launched(lambda: DIPSolver(c, device=cuda, model=make()).solve(
        img, mask, seed=0, spatial_mesh=[cuda] * 2))
    np.testing.assert_allclose(got.history.loss[0], ref.history.loss[0], rtol=rtol)
    assert np.all(np.isfinite(got.history.loss)) and got.out_best.shape == img.shape
    assert n == tuple(2 * k for k in n_ref) and n[0] == n[1] == 2 * 3
    assert (n[2] > 0) == wgrad and (n[3] > 0) == ups
