"""The 3D weight-gradient kernel (csrc/wgrad3d.cu) against its plain version
on a CUDA card, at the edges of its plan: flattened rows, partial bands,
short D, channel tiles, swapped roles, large k, the plain-load path,
determinism, and the model zoo's edge shapes.

Imports only torch and the port, so it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda_wgrad.py -q

Every test skips without a CUDA card (a CUDA kernel has no CPU mode); the
CPU tests check the plan (tests/test_torch_wgrad_plan.py) and the plain
version against the JAX package (tests/test_torch_wgrad.py)."""
import pytest
import torch

from deep_prior_interpolation_tpu_torch.ops import wgrad as WG

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(dev, ci, co, sp, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((1, ci) + sp, generator=g, device=dev).to(dtype)
    dy = torch.randn((1, co) + sp, generator=g, device=dev).to(dtype)
    return x, dy


def _check(x, dy, k):
    """The wrapper's result and that of every grid it may pick, against the
    plain version."""
    before = WG.wgrad3d.launches
    got = WG.wgrad3d(x, dy, k)
    torch.cuda.synchronize()
    assert WG.wgrad3d.launches == before + 1
    ref = WG.wgrad3d_plain(x, dy, k)
    # the same float32 products (bf16 products are exact in float32) summed
    # in other orders
    tol = dict(rtol=1e-4, atol=1e-4 * float(ref.abs().max()))
    torch.testing.assert_close(got, ref, **tol)
    for pl in WG._plans(x.shape[1], dy.shape[1], *x.shape[2:], k, x.dtype == torch.bfloat16):
        torch.testing.assert_close(WG._launch(pl, x, dy), ref, **tol)


@pytest.mark.parametrize("ci,co,sp,k,dtype", [
    (24, 10, (6, 8, 8), 3, torch.bfloat16),        # W = 8: two rows a k-step
    (40, 12, (5, 16, 16), 3, torch.bfloat16),      # W = 16: one row a k-step
    (9, 5, (4, 20, 32), 3, torch.bfloat16),        # H over a partial band
    (6, 4, (2, 8, 16), 3, torch.bfloat16),         # D < k
    (6, 4, (1, 8, 16), 3, torch.bfloat16),         # D = 1
    (37, 35, (4, 8, 16), 3, torch.bfloat16),       # Co > 32, Ci % 16 != 0
    (8, 13, (4, 16, 32), 3, torch.bfloat16),       # Co > Ci: x is the ring
    (6, 3, (7, 6, 16), 5, torch.bfloat16),
    (4, 5, (9, 8, 16), 7, torch.bfloat16),
    (9, 5, (5, 6, 20), 3, torch.bfloat16),         # W % 8 != 0: plain loads
    (105, 35, (8, 16, 16), 3, torch.float32),      # float32, a deep shape
    (7, 9, (5, 9, 12), 5, torch.float32),          # float32, Co > Ci, k = 5
    (256, 256, (8, 4, 4), 3, torch.bfloat16),      # SkipNet's deepest level: W = 4
    (32, 1, (16, 32, 32), 3, torch.float32),       # PartialUNet's head: Co = 1, float32
])
def test_wgrad_kernel_matches_plain(cuda, ci, co, sp, k, dtype):
    x, dy = _inputs(cuda, ci, co, sp, dtype)
    if sp == (4, 20, 32):
        assert any(pl.bands > 1 and sp[1] % pl.hb for pl in WG._plans(ci, co, *sp, k, True))
    _check(x, dy, k)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wgrad_unaligned_base_takes_plain_loads(cuda, dtype):
    """A view that starts one element into its storage: not 16-byte aligned."""
    x, dy = _inputs(cuda, 10, 6, (4, 8, 16), dtype, seed=1)
    xs = torch.empty(x.numel() + 1, device=cuda, dtype=dtype)[1:].view(x.shape)
    xs.copy_(x)
    assert xs.data_ptr() % 16 != 0
    _check(xs, dy, 3)


def test_wgrad_is_deterministic(cuda):
    x, dy = _inputs(cuda, 67, 4, (16, 32, 32), torch.bfloat16, seed=2)
    a = WG.wgrad3d(x, dy, 3)
    b = WG.wgrad3d(x, dy, 3)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
