"""The zoo nets over spatial shards (parallel/spatial_zoo.py) on a CUDA
card, with the kernels: each net's sharded solve over ``[cuda:0] * 2``
against its unsharded card solve at a small size (float32, TF32 off, the
fused loss, ``DPI_PALLAS_WGRAD=1``, one summation order: deterministic
cuDNN and the wgrad kernel's first candidate grid, as
tests/test_torch_cuda_spatial_phase.py runs). The iteration-0 loss holds
to rtol 1e-5, and every shard launches each kernel where the unsharded
step launches it: the skip net's and the U-Net's convs reach the wgrad
kernel and their linear upsamples the upsample kernel; the partial-conv
U-Net's decoder reaches wgrad while its partial convs stay with cuDNN; the
attention gates' one-channel maps reach the upsample kernel.

Imports only torch and the port, so it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda_spatial_zoo.py -q

Every test skips without a CUDA card (the kernels have no CPU mode); the
CPU tests hold the same walks against the unsharded port and the JAX
package (tests/test_torch_spatial_zoo*.py)."""
import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu_torch import Config, DIPSolver
from deep_prior_interpolation_tpu_torch.engine import solver as S
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


# each net, its problem, and which kernels its step must launch (wgrad,
# upsample_bwd)
NETS = {
    "skip": (dict(datadim="3d", net="skip", filters=[4, 8], skip=[4], upsample="linear"),
             lambda: volume(16, 16, 16), (True, True)),
    "unet": (dict(datadim="3d", net="unet", filters=[2, 2, 4, 4, 4], upsample="linear"),
             lambda: volume(16, 32, 16), (True, True)),
    "part": (dict(datadim="3d", net="part", filters=[4, 8], skip=[4]),
             lambda: volume(16, 64, 16), (True, False)),
    "attmultiunet": (dict(datadim="2d", net="attmultiunet", filters=[8, 16, 32],
                          skip=[4, 4], upsample="linear"),
                     lambda: patch(24, 32), (False, True)),
}


@pytest.mark.parametrize("net", list(NETS))
def test_a_zoo_net_over_two_shards_of_the_card(cuda, net):
    kw, problem, (wgrad, ups) = NETS[net]
    c = Config(**{**dict(inputdepth=4, epochs=3, scan_chunk=3, gain=1.0, fused_loss=True,
                         dtype="float32", dropout=0.1), **kw})
    img, mask = problem()
    ref, n_ref = launched(lambda: DIPSolver(c, device=cuda).solve(img, mask, seed=0))
    got, n = launched(lambda: DIPSolver(c, device=cuda).solve(
        img, mask, seed=0, spatial_mesh=[cuda] * 2))
    np.testing.assert_allclose(got.history.loss[0], ref.history.loss[0], rtol=1e-5)
    assert np.all(np.isfinite(got.history.loss)) and got.out_best.shape == img.shape
    assert n == tuple(2 * k for k in n_ref) and n[0] == n[1] == 2 * 3
    assert (n[2] > 0) == wgrad and (n[3] > 0) == ups
