"""The linear upsample's gather backward (csrc/upsample.cu) against its plain
version on a CUDA card, at edge shapes: sizes 1, 2, odd and even, 2D and 3D,
partial tiles, D ranges, non-contiguous gradients.

Imports only torch and the port, so it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda_upsample.py -q

Every test skips without a CUDA card (a CUDA kernel has no CPU mode). The
kernel rounds each product and sum as the plain version does, in the same
order, so float32 is compared bit for bit, and bf16 (one rounding of the
float32 sum, round to nearest even) too."""
import pytest
import torch

from deep_prior_interpolation_tpu_torch.ops import upsample as U

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


# (N, C, *input spatial); the last two walk D ranges of 1 plane and of 2
# planes with a shorter last one
SHAPES = [(1, 1, 1, 1), (2, 3, 5, 7), (3, 2, 33, 65), (1, 4, 1, 3, 2), (2, 3, 5, 9, 17),
          (1, 2, 40, 6, 40), (1, 600, 7, 8, 8)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_equals_the_plain_version(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    ndim = len(shape) - 2
    go = torch.randn(shape[:2] + tuple(2 * s for s in shape[2:]), generator=g,
                     device=cuda).to(dtype)
    before = U.upsample_bwd.launches
    got = U.upsample_bwd(go, ndim)
    torch.cuda.synchronize()
    assert U.upsample_bwd.launches == before + 1
    assert got.shape == shape and got.dtype == dtype
    assert torch.equal(got, U.upsample_bwd_plain(go, ndim))
    assert torch.equal(U.upsample_bwd(go, ndim), got)


def test_a_non_contiguous_gradient_and_autograd(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((1, 3, 4, 6, 5), generator=g, device=cuda, requires_grad=True)
    y = U.linear_upsample2x(x)
    cot = torch.randn((1, 6, 8, 12, 10), generator=g, device=cuda)[:, ::2]
    assert not cot.is_contiguous()
    y.backward(cot)
    assert torch.equal(x.grad, U.upsample_bwd_plain(cot, 3))


def test_the_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        U.upsample_bwd(torch.zeros((1, 1, 4, 4), device=cuda, dtype=torch.float16), 2)
    with pytest.raises(ValueError, match="even"):
        U.upsample_bwd(torch.zeros((1, 1, 4, 5), device=cuda), 2)
