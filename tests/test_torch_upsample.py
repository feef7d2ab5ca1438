"""The x2 linear upsample's gather backward (ops/upsample.py): its plain
version against ``jax.vjp`` of the JAX package's ``models.blocks.upsample``
and against torch autograd of ``F.interpolate`` in float64, and the route
``models.blocks.upsample`` takes for linear modes.

float32: the gather and XLA's transpose of ``jax.image.resize`` sum the same
products in other orders, so they agree to rtol 1e-6 where the terms add up
without cancelling (positive gradients), and to 1e-6 of the largest value
where signs mix. float64 against ``F.interpolate``'s own backward: 1e-12."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deep_prior_interpolation_tpu.models.blocks import upsample as jax_upsample
from deep_prior_interpolation_tpu_torch.models import blocks
from deep_prior_interpolation_tpu_torch.ops import upsample as U

torch.set_num_threads(1)

# input spatial sizes: 1, 2, odd and even, 2D and 3D
SHAPES = [(1, 1), (2, 3), (5, 4), (1, 2, 3), (3, 4, 5), (2, 1, 6)]


def _jax_grad(x: np.ndarray, g: np.ndarray) -> np.ndarray:
    """d/dx <g, upsample(x)> through jax.vjp, channels-last (*spatial, C)."""
    _, vjp = jax.vjp(lambda v: jax_upsample(v, 2, "linear"), jnp.asarray(x))
    return np.asarray(vjp(jnp.asarray(g))[0])


def _to_port(a: np.ndarray) -> torch.Tensor:
    """(*spatial, C) -> (1, C, *spatial)."""
    return torch.from_numpy(np.moveaxis(a, -1, 0)[None].copy())


@pytest.mark.parametrize("spatial", SHAPES)
def test_plain_backward_matches_jax_vjp(spatial):
    rng = np.random.RandomState(len(spatial) * 10 + sum(spatial))
    x = rng.randn(*spatial, 3).astype(np.float32)
    out_sp = tuple(2 * s for s in spatial)
    for g, mixed in ((rng.uniform(0.5, 1.5, out_sp + (3,)).astype(np.float32), False),
                     (rng.randn(*out_sp, 3).astype(np.float32), True)):
        want = _to_port(_jax_grad(x, g))
        got = U.upsample_bwd_plain(_to_port(g), len(spatial))
        assert got.dtype == torch.float32 and got.shape == want.shape
        atol = 1e-6 * float(want.abs().max()) if mixed else 0.0
        torch.testing.assert_close(got, want, rtol=1e-6, atol=atol)


@pytest.mark.parametrize("spatial", [(1, 1), (3, 4), (2, 3, 1), (3, 2, 5)])
def test_plain_backward_matches_autograd_in_float64(spatial):
    gen = torch.Generator().manual_seed(sum(spatial))
    x = torch.randn((2, 3) + spatial, generator=gen, dtype=torch.float64, requires_grad=True)
    y = F.interpolate(x, scale_factor=2, mode={2: "bilinear", 3: "trilinear"}[len(spatial)],
                      align_corners=False)
    g = torch.randn(y.shape, generator=gen, dtype=torch.float64)
    want, = torch.autograd.grad(y, x, g)
    got = U.upsample_bwd_plain(g, len(spatial))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


def test_blocks_upsample_routes_linear_modes_through_the_gather(monkeypatch):
    calls = []
    real = U.upsample_bwd

    def spy(g, ndim):
        calls.append((tuple(g.shape), ndim))
        return real(g, ndim)
    monkeypatch.setattr(U, "upsample_bwd", spy)
    gen = torch.Generator().manual_seed(0)
    for mode, shape in (("bilinear", (1, 2, 3, 4)), ("trilinear", (1, 2, 2, 3, 4)),
                        ("linear", (1, 2, 3, 2, 2))):
        x = torch.randn(shape, generator=gen, requires_grad=True)
        y = blocks.upsample(x, 2, mode)
        assert type(y.grad_fn).__name__ == "_LinearUpsample2xBackward"
        torch.testing.assert_close(
            y, F.interpolate(x, scale_factor=2, align_corners=False,
                             mode={4: "bilinear", 5: "trilinear"}[x.dim()]), rtol=0, atol=0)
        y.sum().backward()
    assert calls == [((1, 2, 6, 8), 2), ((1, 2, 4, 6, 8), 3), ((1, 2, 6, 4, 4), 3)]
    y = blocks.upsample(x, 2, "nearest")  # nearest duplicates: not the gather
    assert "_LinearUpsample2x" not in type(y.grad_fn).__name__


def test_bfloat16_is_one_rounding_of_the_float32_sum():
    gen = torch.Generator().manual_seed(1)
    g = torch.randn((1, 4, 6, 8, 10), generator=gen).to(torch.bfloat16)
    got = U.upsample_bwd(g, 3)  # a CPU tensor takes the plain version
    want = U.upsample_bwd_plain(g.float(), 3).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="even"):
        U.upsample_bwd(torch.zeros(1, 1, 4, 5), 2)
    with pytest.raises(ValueError, match="2 or 3"):
        U.upsample_bwd(torch.zeros(1, 1, 4), 1)
    with pytest.raises(ValueError, match="2 or 3"):
        U.linear_upsample2x(torch.zeros(1, 1, 4))


@pytest.mark.parametrize("planes, d, h, w", [(426, 16, 8, 8), (51, 128, 64, 64), (3, 1, 85, 50),
                                             (1, 1, 1, 1)])
def test_launch_grid_covers_the_input(planes, d, h, w):
    th, tw, span = U.launch_grid(planes, d, h, w)
    assert th * tw <= 256 and tw in (8, 16, 32) and th >= 1
    assert 1 <= span <= d and -(-d // span) <= 65535
    # grid x (planes x tiles) within CUDA's limit; a tile no wider than the
    # input needs beyond the 8-column minimum
    assert planes * -(-h // th) * -(-w // tw) < 2 ** 31
    assert tw <= max(8, 2 * w) and th <= max(1, 2 * h)
