"""Every op of a caller's module over spatial shards
(parallel/spatial_custom.py), as GSPMD partitions it: relayouts for
slices, flips, rolls, concatenations and wrap pads; windows for any conv,
deconv or pool; the whole route (gathered on the first shard's device,
run whole, split back) for FFTs, custom autograd Functions, indices and
the rest; draws made whole and split.

Each module runs unsharded and over [cpu] x 2, an uneven x 3 and x 8
(whose deepest shards hold no plane) along spatial axis 1, in float64:
outputs and every parameter gradient of ``sum(out * cot)`` to 1e-10 of
the largest entry. The 14 ops that the walker refused before this route
existed run; a ``torch.no_grad()`` region gives the unsharded module's
(missing) gradient, a custom Function's own backward runs (a walker that
lost it would leave the conv before it without gradient); the relayout
and window ops gather nothing (``ShardedStep.whole_ops`` empty), the
others list exactly the ops gathered. Draws (``rand_like``,
``randn_like``, ``bernoulli``, alpha and feature dropouts of any rank,
``uniform_``, a draw like a non-contiguous tensor) are the unsharded
module's bits. A circular halo equals
``F.pad``'s circular pad, and its backward adds in the fixed order of the
other edges."""
import math

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from deep_prior_interpolation_tpu_torch.models import Conv, init_weights
from deep_prior_interpolation_tpu_torch.parallel import spatial as S

torch.set_num_threads(1)
CPU = torch.device("cpu")
F64 = torch.float64
TOL = 1e-10
PADDED = (32, 32)
SHARDS = (2, 3, 8)


class Twice(torch.autograd.Function):
    """A custom autograd Function: its forward runs with the gradient off,
    its own backward doubles the cotangent."""

    @staticmethod
    def forward(ctx, x):
        return 2.0 * x

    @staticmethod
    def backward(ctx, g):
        return 2.0 * g


def _quiet(y):
    with torch.no_grad():
        top = y.abs().amax()
    return y / top


class Op(nn.Module):
    """A conv, then ``op(y, self)``; ``extra`` a module the op may use."""

    def __init__(self, op, extra=None):
        super().__init__()
        self.conv, self.op, self.extra = nn.Conv2d(4, 1, 3, padding=1), op, extra

    def forward(self, x):
        return self.op(self.conv(x), self)


# the ops the walker refused before, along spatial axis 1 (the last dim),
# and the ops each sends to the whole route
FORMERLY_REFUSED = {
    "slice": (lambda y, m: torch.cat([y[..., 1:], y[..., :1]], -1), []),
    "flip": (lambda y, m: y.flip(-1), []),
    "roll": (lambda y, m: torch.roll(y, 1, -1), []),
    "fft": (lambda y, m: torch.fft.ifft(torch.fft.fft(y, dim=-1), dim=-1).real,
            ["torch.fft.fft", "torch.fft.ifft"]),
    "function": (lambda y, m: Twice.apply(y), ["Twice.apply"]),
    "no_grad": (lambda y, m: _quiet(y), []),
    "pending_pad": (lambda y, m: F.relu(F.pad(y, (1, 1, 1, 1), mode="reflect"))[..., 1:-1, 1:-1],
                    []),
    "circular": (lambda y, m: F.conv2d(F.pad(y, (1, 1, 1, 1), mode="circular"),
                                       m.conv.weight[:1, :1]), []),
    "indices": (lambda y, m: F.max_unpool2d(*F.max_pool2d(y, 2, return_indices=True), 2),
                ["F.max_pool2d_with_indices", "F.max_unpool2d"]),
    "align_corners": (lambda y, m: F.interpolate(F.avg_pool2d(y, 2), scale_factor=2,
                                                 mode="bilinear", align_corners=True),
                      ["F.interpolate"]),
    "rand_like": (lambda y, m: y + 0.1 * torch.rand_like(y), []),
    "alpha_dropout": (lambda y, m: F.alpha_dropout(y, 0.1, True), []),
    "layer_norm": (lambda y, m: m.extra(y), ["F.layer_norm"]),
    "einsum": (lambda y, m: y * torch.einsum("nchw,nchw->nch", y, y)[..., None],
               ["torch.einsum"]),
}


def _made(make):
    torch.manual_seed(0)
    model = make().double()
    init_weights(model, torch.Generator().manual_seed(0))
    return model


def _compare(model, x, n, axis=1, what=""):
    """``model`` over ``n`` shards against itself unsharded, forward and
    every parameter gradient, each forward after ``torch.manual_seed(7)``;
    returns the sharded step and both outputs."""
    params = list(model.parameters())
    torch.manual_seed(7)
    y = model(x)
    cot = torch.randn(y.shape, generator=torch.Generator().manual_seed(5), dtype=F64)
    ref = torch.autograd.grad((y * cot).sum(), params, allow_unused=True)
    block = S.check_supported(model, x.shape, n, axis, False, F64)
    layout = S.SpatialLayout([CPU] * n, axis, PADDED, PADDED, block)
    step = S.ShardedStep(model, layout)
    torch.manual_seed(7)
    outs = step(layout.split(x))
    got = torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs, layout.split(cot))),
                              params, allow_unused=True)
    whole = torch.cat(outs, 2 + axis).detach()
    what = f"{what} over {n} shards"
    torch.testing.assert_close(whole, y.detach(), rtol=0,
                               atol=TOL * float(y.detach().abs().max()), msg=what)
    g_max = max(float(r.abs().max()) for r in ref if r is not None)
    for (name, _), a, b in zip(model.named_parameters(), got, ref):
        assert (a is None) == (b is None), f"{what}: {name}"
        if b is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=TOL * g_max, msg=f"{what}: {name}")
    return step, whole, y.detach()


@pytest.mark.parametrize("name", list(FORMERLY_REFUSED))
def test_a_formerly_refused_op_runs_as_the_unsharded_module(name):
    op, gathered = FORMERLY_REFUSED[name]
    extra = nn.LayerNorm(list(PADDED)) if name == "layer_norm" else None
    model = _made(lambda: Op(op, extra))
    if extra is not None:   # an affine that is not the identity
        with torch.no_grad():
            extra.weight.uniform_(0.5, 1.5)
            extra.bias.uniform_(-0.5, 0.5)
    x = torch.randn((1, 4) + PADDED, generator=torch.Generator().manual_seed(4), dtype=F64)
    for n in SHARDS:
        step, _, _ = _compare(model, x, n, what=name)
        assert [o.name for o in step.whole_ops] == gathered, (name, n, step.whole_ops)
    if name in ("function", "no_grad"):   # the conv before them has its gradient
        y = model(x)
        (g,) = torch.autograd.grad(y.sum(), [model.conv.weight])
        assert float(g.abs().max()) > 0


class Routes(nn.Module):
    """One op of each route's forms along the sharded (last) dim:
    relayouts (an int index, ``narrow``, ``chunk``, ``select``,
    ``unbind``, ``cat`` with a plain tensor, a constant-value pad taken
    whole), windows (a valid conv, a dilated stride-2 conv padded past its
    reach, a wide-padded 1 x 3 conv, a general deconv, a ceil-mode max
    pool, an average pool that does not count its padding, a ceil-mode
    average pool), and the whole route (``softmax``, ``cumsum``,
    ``normalize``, a matmul contracting the axis, a merging reshape,
    ``sort``, ``topk``, ``max`` with indices, an adaptive pool to another
    extent, a shard list as a conv weight, a library block handed a list
    sharded along another dim), ending in a replicated output that the
    walk splits onto the input's bounds."""

    def __init__(self):
        super().__init__()
        self.valid = nn.Conv2d(4, 4, 3)
        self.dil = nn.Conv2d(4, 4, 3, stride=2, padding=3, dilation=2)
        self.wide = nn.Conv2d(4, 4, (1, 3), padding=(0, 3))
        self.up = nn.ConvTranspose2d(4, 4, 3, stride=2, padding=0, output_padding=1)
        self.mix = nn.Parameter(0.1 * torch.randn(PADDED[1], PADDED[1]))
        self.lib = Conv(4, 4, 3)
        self.head = nn.Conv2d(4, 1, 1)

    def forward(self, x):
        h = F.pad(self.valid(x), (1, 1, 1, 1))                       # 32 -> 30 -> 32
        row = h[:, :, :, 5]                                          # a replicated plane
        a, b = h.chunk(2, dim=-1)
        h = torch.cat([b, a.narrow(-1, 0, 15), h.select(-1, 3)[..., None]], -1)
        h = h + row[..., None] + sum(h.unbind(-1)[:2])[..., None]
        h = torch.cat([h, torch.linspace(0, 1, 32, dtype=h.dtype).expand(1, 4, 32, 32)], 1)
        h = h[:, :4] + h[:, 4:]
        d = self.dil(h)                                              # 32 -> 17
        w = self.wide(F.pad(d, (1, 1), value=0.5))                   # 17 -> 19 -> 23
        p = F.max_pool2d(w, 3, 2, ceil_mode=True)                    # 23 -> 11
        q = F.avg_pool2d(p, 3, 2, 1, count_include_pad=False)        # 11 -> 6
        r = F.avg_pool2d(q, 2, 2, ceil_mode=True, count_include_pad=False)   # 6 -> 3
        u = self.up(r)                                               # 3 -> 8
        v = F.softmax(u, -1) + torch.cumsum(u, -1) + F.normalize(u, dim=-1)
        v = F.interpolate(F.adaptive_avg_pool2d(v, (8, 4)), size=(8, 32))
        s, i = torch.sort(h, dim=-1)
        t = torch.topk(h, 3, dim=-1).values.sum(-1, keepdim=True) + h.max(-1).values[..., None]
        z = torch.matmul(s, self.mix) + t + i.double() * 1e-3 + h.flatten(2).view(h.shape)
        z = z + F.interpolate(v, size=PADDED)
        k = F.conv2d(z[..., :3, :], z[..., :3, :3].mean(0, keepdim=True).expand(4, 4, 3, 3))
        z = z + 1e-2 * k.mean() + self.lib(h.transpose(2, 3))
        return self.head(z).flatten(2).view(1, 1, *PADDED)


ROUTES_GATHERED = [
    "F.pad", "F.softmax", "torch.cumsum", "F.normalize", "F.adaptive_avg_pool2d",
    "torch.sort", "torch.topk", "Tensor.max", "torch.matmul", "Tensor.flatten",
    "torch.conv2d", "Conv's input", "Tensor.flatten"]


def test_every_route_in_one_module():
    model = _made(Routes)
    x = torch.randn((1, 4) + PADDED, generator=torch.Generator().manual_seed(4), dtype=F64)
    for n in SHARDS:
        step, _, _ = _compare(model, x, n, what="routes")
        assert [o.name for o in step.whole_ops] == ROUTES_GATHERED, (n, step.whole_ops)


class Draws(nn.Module):
    """Draws of every kind, one of them like a non-contiguous tensor (an
    FFT along H, then a custom Function, which keeps its input's strides:
    a draw fills memory in order): the output is their
    exact sum (the conv's part is zero), so it is bit-equal where the draws
    are."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(4, 2, 3, padding=1)

    def forward(self, x):
        y = torch.sigmoid(self.conv(x))
        n = torch.empty_like(y).uniform_(-1, 1)
        d = torch.rand_like(y) + torch.randn_like(y) + torch.bernoulli(y) + n
        d = d + F.alpha_dropout(y, 0.2, True) + F.feature_alpha_dropout(y, 0.3, True)
        d = d + F.dropout1d(y[0], 0.4) + F.dropout3d(y, 0.5) + F.dropout(y, 0.25)
        f = Twice.apply(torch.fft.irfft(torch.fft.rfft(y, dim=2), n=y.shape[2], dim=2))
        return 0.0 * y + d + torch.randn_like(f)


def test_draws_are_the_unsharded_modules_bits():
    model = _made(Draws)
    x = torch.randn((1, 4) + PADDED, generator=torch.Generator().manual_seed(4), dtype=F64)
    for n in SHARDS:
        step, whole, ref = _compare(model, x, n, what="draws")
        assert torch.equal(whole, ref)
        assert [o.name for o in step.whole_ops] == ["torch.fft.rfft", "torch.fft.irfft",
                                                    "Twice.apply"]
    with torch.no_grad():   # the draws vary with the seed
        torch.manual_seed(8)
        assert not torch.equal(model(x), ref)


SIZES = [1, 3, 1, 2, 4]   # uneven shards along the last dim: 11 planes


def _fixed_order_backward(gs, lo, hi):
    """The circular halo's backward, plane by plane in the fixed order of
    ``_Relayout``: into each shard its own planes' gradient, then the
    copies in the other shards' outputs in shard order, then the wrapped
    planes (past the volume's ends) in shard order."""
    n, starts = sum(SIZES), [sum(SIZES[:i]) for i in range(len(SIZES))]
    dxs = [g.narrow(-1, lo, s).clone() for g, s in zip(gs, SIZES)]

    def owner(p):
        i = max(k for k, a in enumerate(starts) if a <= p)
        return i, p - starts[i]
    for wrapped in (False, True):
        for i in range(len(SIZES)):
            for k, g in enumerate(gs):
                for pos in range(g.shape[-1]):
                    p = starts[k] - lo + pos
                    j, local = owner(p % n)
                    if j != i or (not 0 <= p < n) != wrapped or (k == i and not wrapped):
                        continue
                    dxs[i][..., local] += g[..., pos]
    return dxs


def test_a_circular_halo_and_its_fixed_order_backward():
    """Halos of 4 and 5 planes wrap round 11 planes on 5 uneven shards:
    each extended shard is ``F.pad(mode="circular")``'s planes, its
    backward the whole pad's gradient (1e-12) and, bit for bit, the
    fixed-order sum."""
    lo, hi = 4, 5
    x = torch.randn(1, 2, 3, sum(SIZES), generator=torch.Generator().manual_seed(0),
                    dtype=F64)
    xs = [t.clone().requires_grad_() for t in x.split(SIZES, -1)]
    shards = S.halo_exchange(xs, 1, lo, hi, "circular")
    pad = F.pad(x, (lo, hi, 0, 0), mode="circular")
    starts = [sum(SIZES[:i]) for i in range(len(SIZES))]
    for t, a, s in zip(shards, starts, SIZES):
        assert torch.equal(t, pad[..., a:a + s + lo + hi])
    gs = [torch.randn(t.shape, generator=torch.Generator().manual_seed(i), dtype=F64)
          for i, t in enumerate(shards)]
    got = torch.autograd.grad(shards, xs, gs)
    assert all(torch.equal(a, b) for a, b in zip(got, _fixed_order_backward(gs, lo, hi)))
    whole = x.clone().requires_grad_()
    padded = F.pad(whole, (lo, hi, 0, 0), mode="circular")
    parts = [padded[..., a:a + s + lo + hi] for a, s in zip(starts, SIZES)]
    (ref,) = torch.autograd.grad(sum((p * g).sum() for p, g in zip(parts, gs)), whole)
    torch.testing.assert_close(torch.cat(got, -1), ref, rtol=1e-12, atol=1e-12)
    assert torch.autograd.gradcheck(lambda *t: S._HaloExchange.apply(1, 2, 3, "circular", *t),
                                    tuple(xs))
    assert math.isclose(float(ref.abs().sum()), float(torch.cat(got, -1).abs().sum()),
                        rel_tol=1e-12)
