"""The port's hand-written kernels against their plain versions on a CUDA card.

Imports only torch and the port, so it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Every test skips without a CUDA card (there is no CPU mode of a Triton or
CUDA kernel); the CPU tests of the port compare the plain versions with the
JAX package instead."""
import pytest
import torch

from deep_prior_interpolation_tpu_torch.ops import fused_loss as FL
from deep_prior_interpolation_tpu_torch.ops import wgrad as WG

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def test_fused_sums_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    shape = (1, 1, 64, 64, 33)
    out = torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)
    img = torch.randn(shape, generator=g, device=cuda)
    mask = (torch.rand(shape, generator=g, device=cuda) > 0.5).float()
    before = FL.fused_sums.launches
    got = FL.fused_sums(out, img, mask)
    assert FL.fused_sums.launches == before + 1
    # float32 sums of 135 k terms in another order
    torch.testing.assert_close(got, FL.fused_sums_plain(out, img, mask), rtol=1e-5, atol=1e-3)


def test_fused_loss_gradient_on_cuda(cuda):
    g = torch.Generator(device=cuda).manual_seed(6)
    out = torch.randn((1, 1, 16, 16, 16), generator=g, device=cuda).requires_grad_(True)
    img = torch.randn(out.shape, generator=g, device=cuda)
    mask = (torch.rand(out.shape, generator=g, device=cuda) > 0.5).float()
    FL.fused_loss_metrics(out, img, mask, "mse")[0].backward()
    ref = 2.0 * (out.detach() - img) * mask * mask / out.numel()
    torch.testing.assert_close(out.grad, ref, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("ci,co,sp,k,dtype", [
    (5, 3, (6, 8, 16), 3, torch.float32),
    (3, 2, (5, 9, 300), 3, torch.float32),       # W > the thread block
    (67, 4, (16, 32, 32), 3, torch.bfloat16),    # co tile 8, 5 ci tiles
    (25, 16, (9, 7, 130), 3, torch.bfloat16),    # W over 3 segments, odd sizes
    (8, 13, (4, 5, 6), 3, torch.bfloat16),       # W below one segment
    (9, 5, (5, 6, 72), 3, torch.bfloat16),       # 16-byte staging, a tail segment
    (7, 3, (4, 5, 24), 5, torch.bfloat16),       # 16-byte staging, W < one segment
    (554, 35, (8, 4, 4), 3, torch.bfloat16),     # co tile 32, 2 co tiles
    (6, 3, (7, 6, 20), 5, torch.bfloat16),
    (4, 2, (9, 8, 11), 7, torch.bfloat16),
])
def test_wgrad_kernel_matches_plain(cuda, ci, co, sp, k, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((1, ci) + sp, generator=g, device=cuda).to(dtype)
    dy = torch.randn((1, co) + sp, generator=g, device=cuda).to(dtype)
    before = WG.wgrad3d.launches
    got = WG.wgrad3d(x, dy, k)
    torch.cuda.synchronize()
    assert WG.wgrad3d.launches == before + 1
    ref = WG.wgrad3d_plain(x, dy, k)
    # the same float32 products (bf16 products are exact in float32) summed
    # in other orders
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))


def test_wgrad_wrapper_refuses_bad_inputs(cuda):
    x = torch.randn(1, 2, 4, 4, 4, device=cuda)
    with pytest.raises(TypeError):
        WG.wgrad3d(x, x.to(torch.bfloat16), 3)
    with pytest.raises(ValueError):
        WG.wgrad3d(x, x.cpu(), 3)
    with pytest.raises(ValueError):
        WG.wgrad3d(x.to(torch.bfloat16), x.to(torch.bfloat16), 9)
