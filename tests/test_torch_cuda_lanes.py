"""The kernels' lane dimension on a CUDA card (a batch of patches,
parallel/mesh.py): the fused loss's B lanes bit-equal to B one-lane
launches, forward and backward; the wgrad kernel's lane launch against its
plain version at two shapes of the 8-lane flagship batch, every candidate
grid of the lane planner included, each lane bit-equal to a one-lane launch
of the same grid; one lane unchanged; the lane launch as the first CUDA
call of a fresh thread (autograd's device thread); a small batched
solve's launch counts; and the overlap-add on the card, bit-equal from call
to call at an overlapping tiling.

Imports only torch and the port, so it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda_lanes.py -q

Every test skips without a CUDA card (the kernels have no CPU mode); the
CPU tests hold the lane paths' plain versions and vmap rules
(tests/test_torch_parallel_*.py)."""
import threading

import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu_torch.ops import fused_loss as FL
from deep_prior_interpolation_tpu_torch.ops import upsample as U
from deep_prior_interpolation_tpu_torch.ops import wgrad as WG

torch.set_num_threads(1)

# two wgrad shapes of the flagship net at the (128, 64, 64) patch: the first
# level's 64 -> 4 and the second's 137 -> 8
LANE_SHAPES = [(64, 4, (128, 64, 64)), (137, 8, (64, 32, 32))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _randn(dev, shape, seed, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def _loss_inputs(dev, b, n, dtype):
    out = _randn(dev, (b, 1, 1, n), 1, dtype)
    img = _randn(dev, (b, 1, 1, n), 2)
    mask = (_randn(dev, (b, 1, 1, n), 3) > 0).float()
    return out, img, mask


@pytest.mark.parametrize("b,n,dtype", [(8, 128 * 64 * 64, torch.bfloat16),
                                       (32, 170 * 100, torch.float32),
                                       (32, 170 * 100, torch.bfloat16)])
def test_lane_fused_loss_equals_one_lane_launches(cuda, b, n, dtype):
    out, img, mask = _loss_inputs(cuda, b, n, dtype)
    g = _randn(cuda, (b, 8), 4)
    before = (FL.fused_sums_lanes.launches, FL.loss_sums_grad_lanes.launches)
    sums = FL.fused_sums_lanes(out, img, mask)
    grad = FL.loss_sums_grad_lanes(out, img, mask, g)
    assert (FL.fused_sums_lanes.launches, FL.loss_sums_grad_lanes.launches) == \
        (before[0] + 1, before[1] + 1)
    for i in range(b):
        o, t, m = out[i].clone(), img[i].clone(), mask[i].clone()
        assert torch.equal(sums[i], FL.fused_sums(o, t, m))
        assert torch.equal(grad[i], FL.loss_sums_grad(o, t, m, g[i].clone()))
    ref = FL.fused_sums_lanes_plain(out, img, mask)
    torch.testing.assert_close(sums, ref, rtol=1e-4, atol=1e-3)


def test_one_lane_is_unchanged(cuda):
    """B = 1 through the lane wrappers: the one-lane kernels' results, bit
    for bit (same grid for wgrad: one tuned grid for the shape)."""
    out, img, mask = _loss_inputs(cuda, 1, 4096 + 8, torch.bfloat16)
    assert torch.equal(FL.fused_sums_lanes(out, img, mask)[0],
                       FL.fused_sums(out[0], img[0], mask[0]))
    x = _randn(cuda, (1, 24, 8, 16, 16), 5, torch.bfloat16)
    dy = _randn(cuda, (1, 12, 8, 16, 16), 6, torch.bfloat16)
    assert torch.equal(WG.wgrad3d_lanes(x, dy, 3)[0], WG.wgrad3d(x, dy, 3))


@pytest.mark.parametrize("ci,co,sp", LANE_SHAPES)
def test_lane_wgrad_matches_plain_and_one_lane_launches(cuda, ci, co, sp):
    b = 8
    x = _randn(cuda, (b, ci) + sp, 7, torch.bfloat16)
    dy = _randn(cuda, (b, co) + sp, 8, torch.bfloat16)
    ref = WG.wgrad3d_lanes_plain(x, dy, 3)
    tol = dict(rtol=1e-4, atol=1e-4 * float(ref.abs().max()))
    before = WG.wgrad3d_lanes.launches
    torch.testing.assert_close(WG.wgrad3d_lanes(x, dy, 3), ref, **tol)
    assert WG.wgrad3d_lanes.launches == before + 1
    for pl in WG._plans(ci, co, *sp, 3, True, b):
        got = WG._launch(pl, x, dy, lanes=True)
        torch.testing.assert_close(got, ref, **tol)
        one = WG._launch(pl, x[3:4].contiguous(), dy[3:4].contiguous())
        assert torch.equal(got[3], one)


def test_lane_wgrad_as_a_fresh_threads_first_cuda_call(cuda):
    """The lane launch as the first CUDA call of a new thread (autograd's
    device thread when the backward's first node is a lane conv) makes its
    5D tensor maps and launches: the same sums as on this thread."""
    x = _randn(cuda, (4, 48, 16, 8, 8), 10, torch.bfloat16)
    dy = _randn(cuda, (4, 40, 16, 8, 8), 11, torch.bfloat16)
    pl = WG._plans(48, 40, 16, 8, 8, 3, True, 4)[0]
    assert int(WG._args(pl, True, 4)[1]) == 1   # the TMA path
    got, errors = [], []

    def first_call():
        try:
            got.append(WG._launch(pl, x, dy, lanes=True))
            torch.cuda.synchronize()
        except RuntimeError as e:
            errors.append(e)
    t = threading.Thread(target=first_call)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and not errors, errors
    assert torch.equal(got[0], WG._launch(pl, x, dy, lanes=True))


def test_a_small_batched_solve_launches_once_for_all_lanes(cuda, monkeypatch):
    """4 lanes of a small 3D net, 3 iterations: each kernel launches once a
    step for the batch (wgrad once a same-pad 3x3x3 conv); the lanes' first
    losses equal their solo solves' on the card to rel 1e-4 (float32)."""
    from deep_prior_interpolation_tpu_torch import Config, DIPSolver
    from deep_prior_interpolation_tpu_torch.engine import solver as S
    from deep_prior_interpolation_tpu_torch.parallel import solve_patches_batched
    monkeypatch.setenv("DPI_PALLAS_WGRAD", "1")
    # the launch counters count calls from Python, which a step replayed from
    # the batch's CUDA graph does not make: the batch steps eagerly
    # (tests/test_torch_cuda_step_graph.py holds the graphed batch to it)
    monkeypatch.setattr(S, "_GRAPHS", False)
    rng = np.random.RandomState(0)
    patches = [{"image": rng.randn(16, 16, 16, 1).astype(np.float32),
                "mask": (rng.rand(16, 16, 16, 1) > 0.4).astype(np.float32), "name": str(i)}
               for i in range(4)]
    cfg = Config(datadim="3d", epochs=3, scan_chunk=3, inputdepth=4, filters=[8, 16],
                 skip=[4], upsample="linear", fused_loss=True, gain=1.0)
    counters = (FL.fused_sums_lanes, FL.loss_sums_grad_lanes, WG.wgrad3d_lanes,
                U.upsample_bwd)
    before = [f.launches for f in counters]
    res = solve_patches_batched(cfg, DIPSolver(cfg, device=cuda), patches)
    launches = [f.launches - b for f, b in zip(counters, before)]
    assert launches[:2] == [3, 3] and launches[2] > 0 and launches[2] % 3 == 0
    assert launches[3] == 3
    for i, (p, r) in enumerate(zip(patches, res)):
        seq = DIPSolver(cfg, device=cuda).solve(p["image"], p["mask"], seed=cfg.seed + i)
        np.testing.assert_allclose(r.history.loss[0], seq.history.loss[0], rtol=1e-4)


def test_overlap_add_on_the_card_repeats_bit_for_bit(cuda):
    """The repaired overlap_add and overlap_add_sharded at an overlapping
    tiling: box adds in tile order, no atomic scatter, so two calls give
    the same bits."""
    from deep_prior_interpolation_tpu_torch.data import overlap_add
    from deep_prior_interpolation_tpu_torch.parallel import make_mesh, overlap_add_sharded
    image, dim, stride = (32, 24, 24), (16, 8, 8), (8, 4, 4)
    n = 3 * 5 * 5
    patches = _randn(cuda, (n,) + dim, 12)
    a, b = overlap_add(patches, image, dim, stride), overlap_add(patches, image, dim, stride)
    assert a.is_cuda and torch.equal(a, b)
    mesh = make_mesh(1)
    c = overlap_add_sharded(patches, image, dim, stride, mesh)
    assert torch.equal(c, overlap_add_sharded(patches, image, dim, stride, mesh))
    torch.testing.assert_close(c, a, rtol=1e-6, atol=1e-6)
