"""Spatial shards (parallel/spatial.py) on CUDA cards: the wgrad kernel
reached by a shard's conv through the padded-dy identity, against the
shard's own weight gradient; a small sharded net's outputs and gradients
against the unsharded net's on the card; the upsample's backward at a
shard shape whose rows TMA cannot read (a 2D net sharded along W) on the
direct kernel, bit-equal to the plain version; a sharded solve's launches
on every shard; and, where there are two cards, each kernel launched on
the second card from a thread whose current device is the first, and a
sharded solve over two cards bit-equal to the same mesh on one card.

Imports only torch and the port, so it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda_spatial.py -q

Every test skips without a CUDA card (the kernels have no CPU mode), the
last two without a second one; the CPU tests hold the sharded paths
against the unsharded port and the JAX package
(tests/test_torch_spatial_*.py)."""
import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu_torch import Config, DIPSolver
from deep_prior_interpolation_tpu_torch.models import get_net, init_weights
from deep_prior_interpolation_tpu_torch.ops import conv_vjp as cv
from deep_prior_interpolation_tpu_torch.ops import fused_loss as FL
from deep_prior_interpolation_tpu_torch.ops import upsample as U
from deep_prior_interpolation_tpu_torch.ops import wgrad as WG
from deep_prior_interpolation_tpu_torch.parallel import make_spatial_mesh
from deep_prior_interpolation_tpu_torch.parallel.spatial import ShardedStep, SpatialLayout

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda:0")


@pytest.fixture
def two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    return [torch.device("cuda:0"), torch.device("cuda:1")]


@pytest.fixture
def no_tf32():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_a_shard_conv_s_weight_gradient_on_the_kernel(cuda, no_tf32, monkeypatch, axis, dtype):
    monkeypatch.setenv("DPI_PALLAS_WGRAD", "1")
    g = torch.Generator(device=cuda).manual_seed(0)
    shape = [12, 10, 16]
    shape[axis] += 2   # the shard's planes with a halo plane on each side
    x = torch.randn((1, 24) + tuple(shape), generator=g, device=cuda).to(dtype)
    w = torch.randn((8, 24, 3, 3, 3), generator=g, device=cuda).requires_grad_()
    y = cv.conv_halo(x, w.to(dtype), axis, 1)
    dy = torch.randn(y.shape, generator=g, device=cuda).to(dtype)
    before = WG.wgrad3d.launches
    (dw,) = torch.autograd.grad(y, w, dy)
    assert WG.wgrad3d.launches == before + 1
    pads = [1, 1, 1]
    pads[axis] = 0
    ref = torch.nn.grad.conv3d_weight(x.float(), w.shape, dy.float(), padding=tuple(pads))
    # float32 sums in another order, then (bf16) the weight's one rounding
    tol = 1e-4 * float(ref.abs().max()) + 1e-4
    if dtype == torch.bfloat16:
        tol = tol + 2.0 ** -8 * ref.abs()
    assert bool(((dw - ref).abs() <= tol).all())


@pytest.mark.parametrize("upsample", ["nearest", "linear"])
@pytest.mark.parametrize("n", [2, 4])
def test_the_sharded_net_on_the_card(cuda, no_tf32, monkeypatch, upsample, n):
    monkeypatch.setenv("DPI_PALLAS_WGRAD", "1")
    cfg = Config(datadim="3d", inputdepth=4, filters=[8, 16, 32], skip=[4, 4],
                 upsample=upsample, dtype="float32")
    net = get_net(cfg, 1)
    init_weights(net, torch.Generator().manual_seed(0))
    net = net.to(cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((1, 4, 16, 16, 8), generator=g, device=cuda)
    cot = torch.randn((1, 1, 16, 16, 8), generator=g, device=cuda)
    params = list(net.parameters())
    y = net(x)
    g0 = torch.autograd.grad((y * cot).sum(), params)
    layout = SpatialLayout([cuda] * n, 1, (16, 16, 8), (16, 16, 8), 4)
    ys = ShardedStep(net, layout)(layout.split(x))
    g1 = torch.autograd.grad(sum((a * b).sum() for a, b in zip(ys, layout.split(cot))), params)
    got, y = layout.gather(ys).detach(), y.detach()
    assert float((got - y).abs().max()) <= 1e-5 * float(y.abs().max())
    for (name, _), a, b in zip(net.named_parameters(), g1, g0):
        if name.endswith("kernel"):
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), name


def test_a_w_shard_of_the_2d_upsample_takes_the_direct_kernel(cuda):
    # a 2D net sharded along W: a shard of 8 columns with its two halo
    # columns upsamples 10 of them, rows of 20 bf16 (40 bytes) TMA cannot read
    g = torch.Generator(device=cuda).manual_seed(2)
    go = torch.randn((1, 24, 44, 20), generator=g, device=cuda).to(torch.bfloat16)
    assert U.plan(24, 1, 22, 10, False, 2, go.data_ptr() % 16 == 0).kernel == "direct"
    before = U.upsample_bwd.direct_launches
    assert torch.equal(U.upsample_bwd(go, 2), U.upsample_bwd_plain(go, 2))
    assert U.upsample_bwd.direct_launches == before + 1


def _solve(cfg, mesh, device, **kw):
    rng = np.random.RandomState(0)
    img = rng.randn(16, 16, 8, 1).astype(np.float32)
    mask = (rng.rand(1, 16, 8, 1) > 0.4).astype(np.float32).repeat(16, 0)
    return DIPSolver(cfg, device=device).solve(img, mask, seed=0, spatial_mesh=mesh,
                                               spatial_axis=1, **kw)


SMALL = dict(datadim="3d", inputdepth=4, filters=[8, 16], skip=[4], upsample="linear",
             epochs=4, scan_chunk=2, fused_loss=True, gain=1.0)


def test_a_sharded_solve_launches_each_kernel_on_every_shard(cuda, monkeypatch):
    monkeypatch.setenv("DPI_PALLAS_WGRAD", "1")
    counters = [FL.fused_sums, FL.loss_sums_grad, U.upsample_bwd, WG.wgrad3d]
    before = [c.launches for c in counters]
    res = _solve(Config(**SMALL, dtype="bfloat16"), make_spatial_mesh(4, [cuda] * 4), cuda)
    fwd, bwd, ups, wg = (c.launches - b for c, b in zip(counters, before))
    assert (fwd, bwd, ups) == (4 * 4, 4 * 4, 4 * 4)
    # the MulResUnet 3D at filters [8, 16]: 11 3x3x3 stride-1 convs a shard
    assert wg == 11 * 4 * 4
    assert np.all(np.isfinite(res.history.loss)) and res.out_best.shape == (16, 16, 8, 1)


def test_each_kernel_launches_on_the_second_card_from_the_first(two_cards):
    dev = two_cards[1]
    g = torch.Generator(device=dev).manual_seed(3)
    torch.cuda.set_device(0)
    img = torch.randn((1, 1, 32, 16, 16), generator=g, device=dev)
    out = (img + torch.randn(img.shape, generator=g, device=dev)).to(torch.bfloat16)
    mask = (torch.rand(img.shape, generator=g, device=dev) > 0.5).float()
    gin = torch.randn(8, generator=g, device=dev)
    sums, ref = FL.fused_sums(out, img, mask), FL.fused_sums_plain(out, img, mask)
    assert float((sums - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    grad = FL.loss_sums_grad(out, img, mask, gin).float()
    gref = FL.loss_sums_grad_plain(out, img, mask, gin).float()
    assert float((grad - gref).abs().max()) <= 2.0 ** -7 * float(gref.abs().max())
    go = torch.randn((1, 8, 16, 16, 16), generator=g, device=dev).to(torch.bfloat16)
    assert torch.equal(U.upsample_bwd(go, 3), U.upsample_bwd_plain(go, 3))
    x = torch.randn((1, 8, 8, 8, 8), generator=g, device=dev).to(torch.bfloat16)
    dy = torch.randn((1, 4, 8, 8, 8), generator=g, device=dev).to(torch.bfloat16)
    ref = WG.wgrad3d_plain(x, dy, 3)
    assert float((WG.wgrad3d(x, dy, 3) - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert torch.cuda.current_device() == 0


def test_a_two_card_mesh_repeats_the_one_card_mesh(two_cards, monkeypatch, tmp_path):
    monkeypatch.setenv("DPI_PALLAS_WGRAD", "1")
    cfg = Config(**SMALL, dtype="float32")
    one = _solve(cfg, [two_cards[0]] * 2, two_cards[0],
                 checkpoint_path=str(tmp_path / "one"), checkpoint_every=1)
    two = _solve(cfg, two_cards, two_cards[0],
                 checkpoint_path=str(tmp_path / "two"), checkpoint_every=1)
    assert np.array_equal(one.history.loss, two.history.loss)
    assert np.array_equal(one.out_best, two.out_best)
