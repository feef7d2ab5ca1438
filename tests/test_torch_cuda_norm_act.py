"""The Norm's kernel pair (ops/norm_act.py, csrc/norm_act.cu) on a CUDA card,
against its plain version in float32 from the same input: at every one of
the 3D MulResUnet's 70 Norm shapes (28 distinct, (256, 128, 128) patch), in
2D, at C = 1, at odd C, with N > 1 and where the channels are not 16-byte
aligned; two calls bit-identical; lanes bit-identical to one-lane calls;
the autograd function and ``Norm`` on the card.

The reference is the kernels' closed form in float32 from the same input
(``closed_forward`` and ``closed_backward`` of tests/test_torch_norm_act.py,
held there against float64 autograd of the tensor ops), and z is held
against ``norm_act_plain`` of the input in float32 as well.

Tolerances. With the kernels' own statistics the plain arithmetic (x g + b,
the activation, one rounding) gives z bit for bit. The statistics and the
gradient's sums are float32 sums in another order: relative 1e-4 (1e-5 of
the largest, for the per-channel vectors that cancel); z against the plain
version's own statistics within one ulp of its dtype (at most 2^-7 of |z| in
bf16, 2^-22 in float32) plus 1e-5 of the largest |z|; dx within one ulp plus
1e-4 of the largest |dx| (its constants c1, c0 are differences of such
sums).

Imports only torch, the port and tests/test_torch_norm_act.py, so it runs
where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda_norm_act.py -q

Every test skips without a CUDA card (the kernels have no CPU mode); the
CPU tests hold the plain versions (tests/test_torch_norm_act.py)."""
import pytest
import torch

from deep_prior_interpolation_tpu_torch.models.blocks import Norm
from deep_prior_interpolation_tpu_torch.ops import norm_act as NA
from test_torch_norm_act import Logged, closed_backward, closed_forward, seed_norm

# the 3D MulResUnet's Norm inputs at the (256, 128, 128) patch: channels,
# spatial, Norms of that shape a step (70 in all)
FLAGSHIP = [(4, (256, 128, 128), 2), (8, (256, 128, 128), 2), (13, (256, 128, 128), 2),
            (25, (256, 128, 128), 6), (16, (256, 128, 128), 3), (25, (128, 64, 64), 1),
            (8, (128, 64, 64), 2), (17, (128, 64, 64), 2), (26, (128, 64, 64), 2),
            (51, (128, 64, 64), 6), (32, (128, 64, 64), 3), (51, (64, 32, 32), 1),
            (17, (64, 32, 32), 2), (35, (64, 32, 32), 2), (53, (64, 32, 32), 2),
            (105, (64, 32, 32), 6), (64, (64, 32, 32), 3), (105, (32, 16, 16), 1),
            (35, (32, 16, 16), 2), (71, (32, 16, 16), 2), (106, (32, 16, 16), 2),
            (212, (32, 16, 16), 6), (128, (32, 16, 16), 3), (212, (16, 8, 8), 1),
            (71, (16, 8, 8), 1), (142, (16, 8, 8), 1), (213, (16, 8, 8), 1),
            (426, (16, 8, 8), 3)]
# 2D, C = 1, N > 1, and channels of S not a multiple of the 16-byte unit
OTHER = [(1, 16, (170, 100)), (1, 1, (64, 64)), (1, 1, (32, 16, 16)), (2, 5, (8, 8, 8)),
         (1, 13, (7, 9, 11)), (1, 4, (3, 5)), (3, 25, (5, 4, 6))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(dev, shape, seed, dtype, c=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (3.0 * torch.randn(shape, generator=g, device=dev) + 1.0).to(dtype)
    dz = torch.randn(shape, generator=g, device=dev).to(dtype)
    c = c or shape[1]
    scale = torch.rand(c, generator=g, device=dev) * 20.0 + 0.5
    bias = torch.randn(c, generator=g, device=dev)
    return x, dz, scale, bias


def _ulp(dtype):
    """One ulp of the dtype, relative to the value: at most 2^(1 - digits)."""
    return 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -22


def _within_an_ulp(got, ref, dtype, rel_of_max):
    err = (got.float() - ref).abs()
    bound = _ulp(dtype) * ref.abs() + rel_of_max * float(ref.abs().max())
    assert bool((err <= bound).all()), float((err - bound).max())


def check_against_plain(x, dz, scale, bias, leaky):
    """The kernels against the plain version from the same input; returns
    (z, stats, dx, dscale, dbias) of the kernels."""
    z, stats = NA.norm_act_forward(x, scale, bias, leaky=leaky)
    dx, ds, db = NA.norm_act_backward(x, dz, stats, leaky)
    ref_z, ref_stats = closed_forward(x[None], scale[None], bias[None], 1e-5, leaky)
    ref_z, ref_stats = ref_z[0], ref_stats[0]
    for j in (0, 1, 2, 3):   # g, b, mean, rstd
        r = ref_stats[:, j]
        torch.testing.assert_close(stats[:, j], r, rtol=1e-4, atol=1e-5 * float(r.abs().max()))
    assert torch.equal(stats[:, 4:], ref_stats[:, 4:])
    # the plain arithmetic from the kernel's statistics: z bit for bit
    with_stats = (x.float() * stats[:, 0].view(1, -1, *[1] * (x.ndim - 2))
                  + stats[:, 1].view(1, -1, *[1] * (x.ndim - 2)))
    if leaky:
        with_stats = torch.nn.functional.leaky_relu(with_stats, NA.SLOPE)
    assert torch.equal(z, with_stats.to(x.dtype))
    _within_an_ulp(z, ref_z.float(), x.dtype, 1e-5)
    _within_an_ulp(z, NA.norm_act_plain(x.float(), scale, bias, leaky=leaky), x.dtype, 1e-5)
    ref_dx, ref_ds, ref_db = closed_backward(x[None], dz[None], stats[None], leaky)
    for got, r in ((ds, ref_ds[0]), (db, ref_db[0])):
        torch.testing.assert_close(got, r, rtol=1e-4, atol=1e-5 * float(r.abs().max()))
    _within_an_ulp(dx, ref_dx[0].float(), x.dtype, 1e-4)
    return z, stats, dx, ds, db


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_every_flagship_norm_shape_against_the_plain_version(cuda, dtype):
    for k, (c, sp, _) in enumerate(FLAGSHIP):
        x, dz, scale, bias = _inputs(cuda, (1, c) + sp, k, dtype)
        check_against_plain(x, dz, scale, bias, leaky=k % 2 == 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_2d_one_channel_several_samples_and_unaligned_channels(cuda, dtype):
    for k, (n, c, sp) in enumerate(OTHER):
        x, dz, scale, bias = _inputs(cuda, (n, c) + sp, 100 + k, dtype)
        for leaky in (False, True):
            check_against_plain(x, dz, scale, bias, leaky)


def test_zero_variance_channels(cuda):
    """A zero channel and a constant one whose sums are exact in any order:
    var 0, not clamped (keep 1), the gain rsqrt(eps), finite gradients as the
    plain version's."""
    x, dz, scale, bias = _inputs(cuda, (1, 3, 16, 16, 16), 7, torch.float32)
    x[:, 0] = 0.0
    x[:, 1] = 0.5
    z, stats, dx, ds, db = check_against_plain(x, dz, scale, bias, leaky=True)
    assert torch.all(stats[:2, 5] == 1) and torch.all(stats[:2, 2] == torch.tensor(
        [0.0, 0.5], device=cuda)) and torch.isfinite(dx).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_two_calls_are_bit_identical(cuda, dtype):
    for c, sp in ((25, (256, 128, 128)), (105, (64, 32, 32)), (13, (7, 9, 11))):
        x, dz, scale, bias = _inputs(cuda, (1, c) + sp, c, dtype)
        a = NA.norm_act_forward(x, scale, bias, leaky=True)
        b = NA.norm_act_forward(x, scale, bias, leaky=True)
        assert all(torch.equal(u, v) for u, v in zip(a, b))
        ga = NA.norm_act_backward(x, dz, a[1], True)
        gb = NA.norm_act_backward(x, dz, a[1], True)
        assert all(torch.equal(u, v) for u, v in zip(ga, gb))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_lanes_are_bit_identical_to_one_lane_calls(cuda, dtype):
    """8 lanes of the lanes8 cell's (128, 64, 64) Norm shapes and a small
    unaligned one, each lane with its own scale and bias; dz a channel slice
    of a wider gradient (a lane stride, as a cat's backward gives)."""
    for c, sp in ((25, (128, 64, 64)), (426, (4, 2, 2)), (13, (7, 9, 11))):
        b = 8
        x, _, scale, bias = _inputs(cuda, (b, 1, c) + sp, c, dtype, c)
        wide = _inputs(cuda, (b, 1, c + 3) + sp, c + 1, dtype)[0]
        dz = wide[:, :, 2:2 + c]
        scale = scale.expand(b, c) * torch.arange(1, b + 1, device=cuda)[:, None]
        bias = bias.expand(b, c) + torch.arange(b, device=cuda)[:, None]
        before = (NA.norm_act_forward_lanes.launches, NA.norm_act_backward_lanes.launches)
        z, stats = NA.norm_act_forward_lanes(x, scale, bias, leaky=True)
        dx, ds, db = NA.norm_act_backward_lanes(x, dz, stats, True)
        assert (NA.norm_act_forward_lanes.launches, NA.norm_act_backward_lanes.launches) == \
            (before[0] + 2, before[1] + 2)
        for i in range(b):
            zi, si = NA.norm_act_forward(x[i].clone(), scale[i].clone(), bias[i].clone(),
                                         leaky=True)
            assert torch.equal(z[i], zi) and torch.equal(stats[i], si)
            gi = NA.norm_act_backward(x[i].clone(), dz[i].clone(), si, True)
            assert all(torch.equal(u, v) for u, v in zip((dx[i], ds[i], db[i]), gi))


def test_the_norm_module_takes_the_kernels_and_vmap_the_lanes(cuda):
    """``Norm`` on the card: the kernel route, 2 launches a direction, its
    gradients as the kernels'; under ``torch.func.vmap`` the lane launches,
    each lane's gradients bit-equal to its one-lane call."""
    x, dz, scale, bias = _inputs(cuda, (1, 16, 32, 16, 16), 3, torch.bfloat16)
    norm = Norm(16).to(cuda)
    with torch.no_grad():
        norm.scale.copy_(scale)
        norm.bias.copy_(bias)
    before = dict(NA.routes), NA.norm_act_forward.launches, NA.norm_act_backward.launches
    xr = x.clone().requires_grad_()
    z = norm(xr, act="LeakyReLU")
    gx, gs, gb = torch.autograd.grad(z, (xr, norm.scale, norm.bias), dz)
    assert NA.routes["kernel"] == before[0].get("kernel", 0) + 1
    assert (NA.norm_act_forward.launches, NA.norm_act_backward.launches) == \
        (before[1] + 2, before[2] + 2)
    zk, stats = NA.norm_act_forward(x, norm.scale.detach(), norm.bias.detach(), leaky=True)
    assert torch.equal(z, zk)
    for u, v in zip((gx, gs, gb), NA.norm_act_backward(x, dz, stats, True)):
        assert torch.equal(u, v)
    xs = torch.stack([x, 2.0 * x]).requires_grad_()
    ps = [torch.stack([p.detach(), 2.0 * p.detach()]).requires_grad_() for p in (scale, bias)]
    n0 = NA.norm_act_forward_lanes.launches
    zs = torch.func.vmap(lambda u, s, c: NA.norm_act(u, s, c, 1e-5, True))(xs, *ps)
    assert NA.norm_act_forward_lanes.launches == n0 + 2
    grads = torch.autograd.grad(zs, [xs] + ps, torch.stack([dz, dz]))
    for i in range(2):
        xi = xs[i].detach().clone().requires_grad_()
        pi = [p[i].detach().clone().requires_grad_() for p in ps]
        zi = NA.norm_act(xi, *pi, 1e-5, True)
        assert torch.equal(zs[i], zi)
        for u, v in zip(grads, torch.autograd.grad(zi, [xi] + pi, dz)):
            assert torch.equal(u[i], v)


@pytest.mark.parametrize("case", ["bfloat16", "float32", "float64", "phase", "shards"])
def test_the_routes_on_the_card(cuda, case):
    """On the card bfloat16 and float32 take the kernels; float64, a Norm of
    phase > 1 and a tensor with ``__torch_function__`` (a list of spatial
    shards) compute the tensor ops as the seed did, bit for bit; ``routes``
    and the launches count each."""
    dtype = {"bfloat16": torch.bfloat16, "float64": torch.float64}.get(case, torch.float32)
    phase = 4 if case == "phase" else 1
    x, _, scale, bias = _inputs(cuda, (1, 8, 8, 6, 6), 71, dtype)
    norm = Norm(8 // phase, phase=phase).to(cuda)
    with torch.no_grad():
        norm.scale.copy_(scale[:8 // phase])
        norm.bias.copy_(bias[:8 // phase])
    if case == "shards":
        x = x.as_subclass(Logged)
    route = "kernel" if case in ("bfloat16", "float32") else "plain"
    before = NA.routes[route], NA.norm_act_forward.launches
    y = norm(x, act="LeakyReLU").as_subclass(torch.Tensor)
    assert (NA.routes[route], NA.norm_act_forward.launches) == \
        (before[0] + 1, before[1] + (2 if route == "kernel" else 0))
    if route == "plain":
        assert torch.equal(y, torch.nn.functional.leaky_relu(
            seed_norm(x.as_subclass(torch.Tensor), norm.scale, norm.bias, phase=phase), 0.2))
    else:   # one rounding: against the plain version in float32
        with torch.no_grad():
            want = NA.norm_act_plain(x.float(), norm.scale, norm.bias, leaky=True)
        _within_an_ulp(y, want, dtype, 1e-5)
