"""The Norm and its activation (ops/norm_act.py) on the CPU: the plain
version is the tensor-op Norm followed by the activation, bit for bit; the
kernels' closed form (``closed_forward`` and ``closed_backward``, the
reference of tests/test_torch_cuda_norm_act.py) against float64 autograd of
the tensor ops; the autograd function and its vmap rule over the launch
wrappers, which the closed form stands in for here (``card``), the lanes
against one-lane calls; and the route ``Norm.forward`` takes, with its
counter on the step's span. Pure Python: no JAX. The kernels themselves run
in tests/test_torch_cuda_norm_act.py."""
import numpy as np
import pytest
import torch
from torch.func import vmap

from deep_prior_interpolation_tpu_torch import Config, DIPSolver
from deep_prior_interpolation_tpu_torch.models.blocks import Norm, get_activation
from deep_prior_interpolation_tpu_torch.ops import norm_act as NA
from deep_prior_interpolation_tpu_torch.parallel import solve_patches_batched
from deep_prior_interpolation_tpu_torch.utils import spans

torch.set_num_threads(1)
SHAPES = {2: (1, 5, 12, 10), 3: (1, 5, 6, 8, 7)}


def seed_norm(x, scale, bias, eps=1e-5, phase=1):
    """The tensor-op Norm.forward as the port wrote it before the kernels."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    axes = [0] + list(range(2, x.ndim))
    s1 = torch.sum(xf, dim=axes)
    s2 = torch.sum(xf * xf, dim=axes)
    n = float(x.numel() // x.shape[1]) * phase
    if phase > 1:
        s1 = s1.view(-1, phase).sum(-1)
        s2 = s2.view(-1, phase).sum(-1)
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    g = scale * torch.rsqrt(var + eps)
    b = bias - mean * g
    if phase > 1:
        g, b = (v.unsqueeze(1).expand(-1, phase).reshape(-1) for v in (g, b))
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return x * g.to(x.dtype).view(shape) + b.to(x.dtype).view(shape)


def _inputs(shape, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    x = (3.0 * torch.randn(shape, generator=g) + 1.0).to(dtype)
    c = shape[1] if len(shape) > 1 else shape[0]
    scale = torch.rand(c, generator=g, dtype=torch.float64) + 0.5
    bias = torch.randn(c, generator=g, dtype=torch.float64)
    return x, scale.float(), bias.float()


def _lane_bcast(v, ndim):
    """(B, C) -> (B, 1, C, 1, ...) for a (B, N, C, ...) tensor of rank ndim."""
    return v.view(v.shape[0], 1, -1, *([1] * (ndim - 3)))


def closed_forward(x, scale, bias, eps, leaky):
    """(z, stats) of (B, N, C, ...) lanes, scale and bias (B, C), as the
    forward kernels compute them: float32 one-pass statistics, z = act(x g +
    b) in float32 rounded once; stats (B, C, 8) (g, b, mean, rstd, scale,
    keep, 0, 0), keep 0 where the variance was clamped."""
    xf = x.float()
    axes = [1] + list(range(3, x.ndim))
    n = float(x[0].numel() // x.shape[2])
    mean = xf.sum(axes) / n
    raw = (xf * xf).sum(axes) / n - mean * mean
    rstd = torch.rsqrt(raw.clamp(min=0.0) + eps)
    g = scale * rstd
    b = bias - mean * g
    y = xf * _lane_bcast(g, x.ndim) + _lane_bcast(b, x.ndim)
    z = torch.nn.functional.leaky_relu(y, negative_slope=NA.SLOPE) if leaky else y
    zero = torch.zeros_like(g)
    stats = torch.stack([g, b, mean, rstd, scale.expand_as(g), (raw >= 0).float(), zero, zero],
                        dim=-1)
    return z.to(x.dtype), stats


def closed_backward(x, dz, stats, leaky):
    """(dx, dscale, dbias) of (B, N, C, ...) lanes in the backward kernels'
    closed form: dy = dz act'(x g + b), dx = g dy + c1 x + c0."""
    xf, d = x.float(), dz.float()
    g, b, mean, rstd, scale, keep = stats.unbind(-1)[:6]
    axes = [1] + list(range(3, x.ndim))
    n = float(x[0].numel() // x.shape[2])
    y = xf * _lane_bcast(g, x.ndim) + _lane_bcast(b, x.ndim)
    dy = torch.where(y > 0, d, d * NA.SLOPE) if leaky else d
    sy, sxy = dy.sum(axes), (dy * xf).sum(axes)
    gg = sxy - mean * sy
    dvar = torch.where(keep != 0, gg * scale * -0.5 * (rstd * rstd * rstd), torch.zeros_like(gg))
    dmean = -(g * sy) + dvar * (-2.0 * mean)
    dx = (_lane_bcast(g, x.ndim) * dy + _lane_bcast(2.0 * dvar / n, x.ndim) * xf
          + _lane_bcast(dmean / n, x.ndim))
    return dx.to(x.dtype), gg * rstd, sy


def _forward_one(x, scale, bias, eps=1e-5, leaky=False):
    z, stats = closed_forward(x[None], scale[None], bias[None], eps, leaky)
    return z[0], stats[0]


def _backward_one(x, dz, stats, leaky=False):
    return tuple(t[0] for t in closed_backward(x[None], dz[None], stats[None], leaky))


def _forward_lanes(x, scale, bias, eps=1e-5, leaky=False):
    b = x.shape[0]
    return closed_forward(x, scale.expand(b, -1), bias.expand(b, -1), eps, leaky)


def stand_in_for_the_card(monkeypatch):
    """The kernel route on the CPU: ``takes_kernel`` as on the card, and the
    closed form in place of the four launch wrappers."""
    monkeypatch.setattr(NA, "takes_kernel", lambda x, phase=1: (
        phase == 1 and type(x) is torch.Tensor and x.device.type == "cpu"
        and x.dtype in (torch.bfloat16, torch.float32)))
    for name, fn in (("norm_act_forward", _forward_one), ("norm_act_backward", _backward_one),
                     ("norm_act_forward_lanes", _forward_lanes),
                     ("norm_act_backward_lanes", closed_backward)):
        monkeypatch.setattr(NA, name, fn)


@pytest.fixture
def card(monkeypatch):
    stand_in_for_the_card(monkeypatch)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64])
def test_plain_is_the_tensor_op_norm_then_its_activation(dtype):
    """In 2D and 3D, with no activation, LeakyReLU (fused on the kernel
    route) and another one (applied after the Norm)."""
    for ndim, act in [(n, a) for n in (2, 3) for a in (None, "LeakyReLU", "Tanh")]:
        x, scale, bias = _inputs(SHAPES[ndim], ndim, dtype)
        norm = Norm(x.shape[1])
        with torch.no_grad():
            norm.scale.copy_(scale)
            norm.bias.copy_(bias)
        want = get_activation(act)(seed_norm(x, norm.scale, norm.bias))
        if act != "Tanh":
            assert torch.equal(NA.norm_act_plain(x, norm.scale, norm.bias,
                                                 leaky=act == "LeakyReLU"), want)
        assert torch.equal(norm(x, act=act), want)


def test_plain_phase_norm_is_the_tensor_op_norm():
    x, scale, bias = _inputs((1, 12, 4, 6, 6), 4)
    want = seed_norm(x, scale[:3], bias[:3], phase=4)
    assert torch.equal(NA.norm_act_plain(x, scale[:3], bias[:3], phase=4), want)


def _float64_grads(x, scale, bias, dz, leaky):
    xs = [t.double().requires_grad_() for t in (x, scale, bias)]
    z = seed_norm(*xs)
    if leaky:
        z = torch.nn.functional.leaky_relu(z, 0.2)
    return z.detach(), torch.autograd.grad(z, xs, dz.double())


@pytest.mark.parametrize("ndim", [2, 3])
def test_closed_form_matches_float64_autograd(card, ndim):
    """The kernels' arithmetic: z and (dx, dscale, dbias) within float32
    rounding of float64 autograd of the tensor ops, directly and through
    the autograd function ``norm_act``; a zero channel (var 0) included."""
    for leaky in (False, True):
        x, scale, bias = _inputs(SHAPES[ndim], 10 + ndim)
        x[:, 2] = 0.0
        dz = _inputs(SHAPES[ndim], 20 + ndim)[0]
        z64, want = _float64_grads(x, scale, bias, dz, leaky)
        z, stats = _forward_one(x, scale, bias, leaky=leaky)
        got = _backward_one(x, dz, stats, leaky)
        assert stats.shape == (x.shape[1], 8) and torch.all(stats[:, 5] == 1)
        torch.testing.assert_close(z.double(), z64, rtol=1e-5,
                                   atol=1e-5 * float(z64.abs().max()))
        for a, b in zip(got, want):
            torch.testing.assert_close(a.double(), b, rtol=1e-4,
                                       atol=1e-5 * float(b.abs().max()))
        xs = [t.clone().requires_grad_() for t in (x, scale, bias)]
        zf = NA.norm_act(*xs, 1e-5, leaky)
        assert torch.equal(zf, z)
        for a, b in zip(torch.autograd.grad(zf, xs, dz), got):
            assert torch.equal(a, b)


def test_a_clamped_variance_drops_the_variance_term():
    """A constant channel whose one-pass variance rounds below 0: keep 0,
    and the gradients are float32 autograd of the tensor ops (which clamp
    the same sums), so the clamp passes nothing either way."""
    x, scale, bias = _inputs((1, 3, 7, 9, 11), 30)
    x[:, 1] = 0.1
    dz = _inputs((1, 3, 7, 9, 11), 31)[0]
    _, stats = _forward_one(x, scale, bias, leaky=True)
    assert stats[1, 5] == 0 and stats[0, 5] == 1
    xs = [t.clone().requires_grad_() for t in (x, scale, bias)]
    want = torch.autograd.grad(torch.nn.functional.leaky_relu(seed_norm(*xs), 0.2), xs, dz)
    for a, b in zip(_backward_one(x, dz, stats, True), want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * float(b.abs().max()))


def test_lanes_equal_one_lane_calls(card):
    """B lanes of (N, C, ...) with their own (or one shared) scale and bias:
    ``norm_act_lanes`` and ``norm_act`` under vmap, with their gradients,
    hand the lane wrappers all B lanes at once and equal one-lane calls
    lane by lane."""
    b, shape = 3, (1, 4, 5, 6, 3)
    x = torch.stack([_inputs(shape, 40 + i)[0] for i in range(b)])
    dz = torch.stack([_inputs(shape, 50 + i)[0] for i in range(b)])
    for shared in (False, True):
        scale = torch.stack([_inputs(shape, 60 + i)[1] for i in range(b)])
        bias = torch.stack([_inputs(shape, 60 + i)[2] for i in range(b)])
        if shared:
            scale, bias = scale[0], bias[0]
        lane = [(scale, bias) if shared else (scale[i], bias[i]) for i in range(b)]
        z = torch.stack([_forward_one(x[i], *lane[i], leaky=True)[0] for i in range(b)])
        grads = []
        for i in range(b):
            ins = [t.clone().requires_grad_() for t in (x[i],) + lane[i]]
            grads.append(torch.autograd.grad(NA.norm_act(*ins, 1e-5, True), ins, dz[i]))
        dx, ds, db = (torch.stack(g) for g in zip(*grads))
        if shared:
            ds, db = ds.sum(0), db.sum(0)
        xs, ss, bs = (t.clone().requires_grad_() for t in (x, scale, bias))
        zl = NA.norm_act_lanes(xs, ss, bs, 1e-5, True)
        zv = vmap(lambda u, s, c: NA.norm_act(u, s, c, 1e-5, True),
                  in_dims=(0, None, None) if shared else 0)(xs, ss, bs)
        assert torch.equal(zv, z) and torch.equal(zl, z)
        for zz in (zl, zv):
            gx, gs, gb = torch.autograd.grad(zz, (xs, ss, bs), dz)
            assert torch.equal(gx, dx) and torch.equal(gs, ds) and torch.equal(gb, db)


class Logged(torch.Tensor):
    """A tensor with ``__torch_function__``, as a list of spatial shards is."""
    calls = 0

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        cls.calls += 1
        return super().__torch_function__(func, types, args, kwargs or {})


@pytest.mark.parametrize("case", ["float32", "bfloat16", "float64", "phase", "shards"])
def test_the_route_and_its_counter(monkeypatch, case):
    """On the CPU every Norm computes the tensor ops as the seed did, and
    ``routes`` counts it as plain (the card's routes are held in
    tests/test_torch_cuda_norm_act.py)."""
    dtype = {"bfloat16": torch.bfloat16, "float64": torch.float64}.get(case, torch.float32)
    phase = 4 if case == "phase" else 1
    x, scale, bias = _inputs((1, 8, 4, 6, 6), 70, dtype)
    norm = Norm(8 // phase, phase=phase)
    if case == "shards":
        x = x.as_subclass(Logged)
    monkeypatch.setattr(NA, "routes", NA.collections.Counter())
    calls = Logged.calls
    y = norm(x, act="LeakyReLU")
    assert dict(NA.routes) == {"plain": 1}
    want = torch.nn.functional.leaky_relu(
        seed_norm(torch.Tensor(x), norm.scale, norm.bias, phase=phase), 0.2)
    assert torch.equal(torch.Tensor(y), want)
    assert (Logged.calls > calls) == (case == "shards")


def test_the_kernel_route_and_its_counter(card, monkeypatch):
    """Where ``takes_kernel`` holds, ``Norm.forward`` counts a kernel Norm (and
    with LeakyReLU a fused one) and computes the kernels' arithmetic with
    LeakyReLU fused, within a rounding of the tensor ops; another activation
    runs after it."""
    for dtype in (torch.bfloat16, torch.float32):
        x, scale, bias = _inputs((1, 8, 4, 6, 6), 70, dtype)
        norm = Norm(8)
        for act in ("LeakyReLU", "Tanh"):
            monkeypatch.setattr(NA, "routes", NA.collections.Counter())
            y = norm(x, act=act)
            assert dict(NA.routes) == ({"kernel": 1, "fused": 1} if act == "LeakyReLU"
                                       else {"kernel": 1})
            want = get_activation(act)(seed_norm(x, norm.scale, norm.bias))
            tol = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
            torch.testing.assert_close(y.float(), want.float(), rtol=tol,
                                       atol=tol * float(want.detach().abs().max()))


def _problem(seed):
    rng = np.random.RandomState(seed)
    img = rng.randn(8, 16, 16, 1).astype(np.float32)
    mask = np.repeat((rng.rand(1, 16, 16, 1) > 0.4).astype(np.float32), 8, 0)
    return img, mask


@pytest.mark.parametrize("entry,on_card", [("solve", False), ("solve", True),
                                           ("batched", True)])
def test_the_steps_norms_on_their_spans(monkeypatch, entry, on_card):
    """A tiny 3D MulResUnet solve (22 Norms a step, 15 with LeakyReLU
    after them): ``step.forward`` reads norm_kernel / norm_plain /
    norm_act_fused 22 / 0 / 15 through the kernel route (under vmap in the
    batched entry) and 0 / 22 / 0 on the CPU's; the kernel route's closed
    form solves as the tensor ops do, to float32 rounding."""
    cfg = Config(datadim="3d", epochs=2, scan_chunk=2, inputdepth=4, filters=[4, 8],
                 skip=[4], gain=1.0)
    losses = {}
    for on in sorted({False, on_card}):
        if on:
            stand_in_for_the_card(monkeypatch)
        solver = DIPSolver(cfg, 1, device=torch.device("cpu"))
        spans.enable()
        try:
            if entry == "batched":
                res = solve_patches_batched(cfg, solver, [
                    dict(zip(("image", "mask"), _problem(i))) for i in (0, 1)])
            else:
                res = [solver.solve(*_problem(0), seed=3)]
        finally:
            spans.disable()
        fwd = [r.attrs for r in spans.drain() if r.name == "step.forward"]
        assert fwd == [{"norm_kernel": 22 if on else 0, "norm_plain": 0 if on else 22,
                        "norm_act_fused": 15 if on else 0}] * 2
        losses[on] = np.asarray([r.history.loss for r in res])
    np.testing.assert_allclose(losses[on_card], losses[False], rtol=1e-5)
