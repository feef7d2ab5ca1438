"""The upsample backward's two CUDA kernels (csrc/upsample.cu) against the
plain version on a card, bit for bit in bf16 and float32: the TMA ring at
its edges (a D range shorter than the ring, D = 1, partial H and W tiles,
the halo at both edges of every axis, 2D plane groups), the direct kernel
where the planner sends it (rows that are not a multiple of 16 bytes, a
gradient at an unaligned address), each kernel's launch counter, and the
first launch on autograd's fresh device thread.

Imports only torch and the port, so it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda_upsample_tma.py -q

Every test skips without a CUDA card (a CUDA kernel has no CPU mode)."""
import os
import subprocess
import sys

import pytest
import torch

from deep_prior_interpolation_tpu_torch.ops import upsample as U

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _counts():
    return U.upsample_bwd.launches, U.upsample_bwd.tma_launches, U.upsample_bwd.direct_launches


def _run(cuda, go, ndim, kernel):
    """One upsample_bwd call: the kernel the planner names, one launch counted
    on it and on the sum, bit-equal to the plain version."""
    before = _counts()
    got = U.upsample_bwd(go, ndim)
    torch.cuda.synchronize()
    step = (1, 1, 0) if kernel == "tma" else (1, 0, 1)
    assert _counts() == tuple(a + b for a, b in zip(before, step))
    assert torch.equal(got, U.upsample_bwd_plain(go, ndim))


def _grad(cuda, shape, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn(shape[:2] + tuple(2 * s for s in shape[2:]), generator=g,
                       device=cuda).to(dtype)


# (N, C, *input spatial), all TMA-readable: D = 2 (a range shorter than the
# ring), D = 1, partial H and W tiles (21 of 16-row tiles, 40 of 64-column
# ones), D ranges with a shorter last one, 2D plane groups with a partial last
# group, 8-column tiles of 4 columns
TMA_SHAPES = [(1, 2, 2, 16, 64), (1, 3, 1, 20, 36), (2, 3, 5, 21, 40), (1, 5, 37, 9, 12),
              (3, 7, 20, 36), (1, 600, 3, 4, 4)]


@pytest.mark.parametrize("shape", TMA_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_tma_kernel_equals_the_plain_version(cuda, shape, dtype):
    go = _grad(cuda, shape, dtype, sum(shape))
    ndim = len(shape) - 2
    d, h, w = ((1,) + shape[2:]) if ndim == 2 else shape[2:]
    assert U.plan(shape[0] * shape[1], d, h, w, ndim == 3, go.element_size()).kernel == "tma"
    _run(cuda, go, ndim, "tma")


def test_an_unaligned_gradient_takes_the_direct_kernel(cuda):
    # a contiguous view 2 bytes past a 16-byte boundary: the planner sends it
    # to the direct kernel (it is not copied)
    shape = (1, 4, 3, 8, 16)
    base = _grad(cuda, (1, 4 * 3 * 8 * 16 * 8 + 1), torch.bfloat16, 5).reshape(-1)
    go = base[1:].view((1, 4, 6, 16, 32))
    assert go.is_contiguous() and go.data_ptr() % 16 != 0
    assert U.plan(4, 3, 8, 16, True, 2, aligned=False).kernel == "direct"
    _run(cuda, go, 3, "direct")
    assert shape == tuple(U.upsample_bwd(go, 3).shape)


# rows of 2 W elements that are not a multiple of 16 bytes: W = 7 and 14 in
# bf16 (the lines net's two coarsest bilinear upsamples), W = 7 in float32
@pytest.mark.parametrize("shape, dtype", [((1, 3, 4, 6, 7), torch.bfloat16),
                                          ((2, 5, 22, 14), torch.bfloat16),
                                          ((1, 2, 3, 5, 7), torch.float32)])
def test_the_direct_kernel_where_the_planner_sends_it(cuda, shape, dtype):
    go = _grad(cuda, shape, dtype, 3)
    ndim = len(shape) - 2
    d, h, w = ((1,) + shape[2:]) if ndim == 2 else shape[2:]
    assert U.plan(shape[0] * shape[1], d, h, w, ndim == 3, go.element_size()).kernel == "direct"
    _run(cuda, go, ndim, "direct")


def test_the_first_launch_on_autograd_s_fresh_thread(cuda):
    # a new process: autograd's device thread has made no CUDA call when the
    # upsample's backward, the first node, encodes its tensor map there
    code = (
        "import torch\n"
        "from deep_prior_interpolation_tpu_torch.ops import upsample as U\n"
        "x = torch.randn((1, 3, 4, 8, 16), device='cuda', dtype=torch.bfloat16,"
        " requires_grad=True)\n"
        "y = U.linear_upsample2x(x)\n"
        "g = torch.randn(y.shape, device='cuda', dtype=torch.bfloat16)\n"
        "y.backward(g)\n"
        "torch.cuda.synchronize()\n"
        "assert torch.equal(x.grad, U.upsample_bwd_plain(g, 3))\n"
        "assert U.upsample_bwd.tma_launches == 1\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]
