"""A module of the caller's own over spatial shards
(parallel/spatial_custom.py): each of the walker's vocabulary classes in a
small module of its own, against the unsharded module in float64 on the
CPU, over 2 and 4 shards along axes 0 and 1, forward and every parameter
gradient of ``sum(out * cot)``, to 1e-12 of the largest output and
gradient; no gradient is None or all zeros.

The modules: local ops (splits, casts, ``where``, ``softmax``, slices and
permutations off the sharded dim, a nearest resize and a pool whose kernel
is its stride); halo ops over a (16, 16) volume whose quarter-resolution
shards hold one plane over 4 shards (a stride-2 conv, reflect and
replicate pads kept pending for the next conv, a padded max pool, a
kernel-5, an even ``'same'`` and a dilated conv, a padded avg pool, a
transposed conv, bilinear and bicubic resizes); spatial reductions (batch
norm with its running statistics, group, instance and layer norms, sums,
means, stds, variances, maxima, adaptive pools) feeding a ``Linear``; the
port's own ops (``conv_same`` at strides 1 and 2, the phase-space convs
and layout changes, ``blocks.upsample``, ``lanczos_downsample``,
``upsample_into_phase``, ``concat_crop``); library nets called inside the
forward (the MulResUnet, a subclass of the skip net that keeps its
forward, a stride-2 ``Conv``) beside the caller's own parameter and
buffer; dropout (``nn.Dropout``, ``nn.Dropout2d`` and ``blocks.Dropout``),
whose masks are the unsharded module's bit for bit; a module that takes the
mask. The shard block the meta pass finds is 2^S for S stride-2 steps, and
a solve through ``DIPSolver(model=...)`` follows the unsharded one."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from deep_prior_interpolation_tpu_torch import Config, DIPSolver
from deep_prior_interpolation_tpu_torch.engine import solver as E
from deep_prior_interpolation_tpu_torch.models import (CBAM, Conv, SkipNet, get_net,
                                                       init_weights, set_dropout_generator)
from deep_prior_interpolation_tpu_torch.models.blocks import (Dropout, concat_crop,
                                                              lanczos_downsample, upsample)
from deep_prior_interpolation_tpu_torch.ops import phase_space as ps
from deep_prior_interpolation_tpu_torch.ops.conv_vjp import conv_same
from deep_prior_interpolation_tpu_torch.parallel import spatial as S

torch.set_num_threads(1)
CPU = torch.device("cpu")
F64 = torch.float64
TIGHT = 1e-12
PADDED = (16, 16)
CASES = [(2, 0), (4, 1), (4, 0), (2, 1)]


class Local(nn.Module):
    """Ops that are local on shards."""

    def __init__(self):
        super().__init__()
        self.mix = nn.Conv2d(8, 1, 1)

    def forward(self, x):
        a, b = x.chunk(2, dim=1)
        h = torch.cat([torch.tanh(a) * 2.0 - 1, F.silu(b).clamp(-1, 1)], 1)
        h = torch.where(h > 0, h, 0.5 * h).float().double()
        h = F.softmax(h, dim=1) + h[:, :1] + h.sum(dim=1, keepdim=True)
        h = h.permute(0, 2, 3, 1).reshape(1, h.shape[2], h.shape[3], 4).permute(0, 3, 1, 2)
        h = F.max_pool2d(F.interpolate(h, scale_factor=2, mode="nearest"), 2)
        return self.mix(torch.stack([h, -h.abs()], 2).flatten(1, 2))


class Halo(nn.Module):
    """Ops that take a halo along the axis."""

    def __init__(self):
        super().__init__()
        self.down = nn.Conv2d(4, 4, 3, stride=2, padding=1)
        self.refl = nn.Conv2d(4, 4, 3, padding=1, padding_mode="reflect")
        self.rep = nn.Conv2d(4, 4, 3)
        self.wide = nn.Conv2d(4, 4, 5, padding=2)
        self.even = nn.Conv2d(4, 4, 4, padding="same")
        self.dil = nn.Conv2d(4, 4, 3, padding=2, dilation=2)
        self.up = nn.ConvTranspose2d(4, 4, 4, stride=2, padding=1)
        self.head = nn.Conv2d(8, 1, 3, padding=1)

    def forward(self, x):
        h = F.leaky_relu(self.down(x), 0.2)
        h = self.rep(F.pad(self.refl(h), (1, 1, 1, 1), mode="replicate"))
        h = F.max_pool2d(h, 3, 2, 1)
        h = F.avg_pool2d(self.dil(self.even(self.wide(h))), 3, 1, 1)
        u = F.interpolate(self.up(h), scale_factor=2, mode="bilinear")
        v = F.avg_pool2d(F.interpolate(x, scale_factor=2, mode="bicubic"), 2)
        return self.head(torch.cat([u, v], 1))


class Stats(nn.Module):
    """Spatial reductions into replicated values."""

    def __init__(self):
        super().__init__()
        self.bn = nn.BatchNorm2d(4)
        self.gn = nn.GroupNorm(2, 4)
        self.inorm = nn.InstanceNorm2d(4, affine=True)
        self.ln = nn.LayerNorm(list(PADDED), elementwise_affine=False)
        self.gate = nn.Linear(4, 4)
        self.head = nn.Conv2d(4, 1, 3, padding=1)

    def forward(self, x):
        h = self.ln(self.inorm(self.gn(self.bn(x))))
        m, s = h.mean(dim=(2, 3)), h.std(dim=(2, 3))
        t = torch.amax(h, dim=(2, 3)) - torch.amin(h, dim=(2, 3))
        g = torch.sigmoid(self.gate(m + s + 0.1 * t + h.var(dim=(2, 3), unbiased=False)))
        a = F.adaptive_avg_pool2d(h, 1) + F.adaptive_max_pool2d(h, (1, None))
        return self.head(h * g[:, :, None, None] + a + 1e-3 * h.sum()) + h.max()


class PortOps(nn.Module):
    """The port's own ops, called on the caller's parameters."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(1)
        self.w = nn.Parameter(0.2 * torch.randn(4, 4, 3, 3, generator=g))
        self.w2 = nn.Parameter(0.2 * torch.randn(4, 4, 3, 3, generator=g))
        self.wp = nn.Parameter(0.2 * torch.randn(4, 4, 3, 3, generator=g))
        self.wo = nn.Parameter(0.2 * torch.randn(1, 8, 3, 3, generator=g))

    def forward(self, x):
        h = conv_same(x, self.w, 1, 1)
        d = conv_same(h, self.w2, 2, 1)
        p = ps.phase_conv(ps.phase_entry_conv(d, self.wp), self.wp)
        u = upsample(upsample(ps.phase_exit_conv(p, self.wp), 2, "bilinear"), 2, "nearest")
        q = ps.depth_to_space(ps.upsample_into_phase(lanczos_downsample(h, 2, 2), "linear"))
        q = ps.depth_to_space(ps.space_to_depth(q))
        return conv_same(concat_crop([u, q]), self.wo, 1, 1)


class MySkip(SkipNet):
    """A subclass that keeps the skip net's forward (and walk)."""


class Children(nn.Module):
    """Library nets called inside the forward, the caller's own parameter
    and buffer."""

    def __init__(self):
        super().__init__()
        c = Config(datadim="2d", inputdepth=4, filters=[4, 8], skip=[4], upsample="linear")
        self.body = get_net(c, 1)
        self.skip = MySkip(4, 1, 2, (4, 4), (2,), upsample_mode="bilinear")
        self.conv = Conv(4, 4, 3, stride=2)
        self.scale = nn.Parameter(torch.tensor(0.5))
        self.register_buffer("shift", torch.linspace(-1.0, 1.0, 4).view(1, 4, 1, 1))

    def forward(self, x):
        d = self.conv(x + self.shift)
        return self.body(x) + self.scale * self.skip(upsample(d, 2, "nearest"))


class Drops(nn.Module):
    """Dropout three ways: the output's zeros are the masks'."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(4, 4, 3, padding=1)
        self.drop, self.drop2, self.mine = nn.Dropout(0.3), nn.Dropout2d(0.3), Dropout(0.3)

    def forward(self, x):
        return self.mine(self.drop2(self.drop(self.conv(x))))[:, :1]


class Masked(nn.Module):
    """A module that takes the mask."""

    takes_mask = True

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(8, 1, 3, padding=1)

    def forward(self, x, mask):
        frac = F.avg_pool2d(mask[:, :1], 3, 1, 1)
        return self.conv(torch.cat([x * mask, x], 1)) * (1.0 + frac)


MODULES = {"local": Local, "halo": Halo, "stats": Stats, "port_ops": PortOps,
           "children": Children, "dropout": Drops, "mask": Masked}


def _made(make):
    torch.manual_seed(0)
    model = make().double()
    init_weights(model, torch.Generator().manual_seed(0))
    return model


def _forward(model, call, args):
    """``call(*args)`` with each dropout's generator seeded as before."""
    set_dropout_generator(model, torch.Generator().manual_seed(9))
    torch.manual_seed(7)
    return call(*args)


@pytest.mark.parametrize("name", list(MODULES))
def test_each_vocabulary_class_is_its_module_in_float64(name):
    model = _made(MODULES[name])
    params = list(model.parameters())
    takes_mask = getattr(model, "takes_mask", False)
    for n, axis in CASES:
        g = torch.Generator().manual_seed(4)
        x = torch.randn((1, 4) + PADDED, generator=g, dtype=F64)
        args = [x, (torch.rand(x.shape, generator=g) > 0.5).to(F64)] if takes_mask else [x]
        bufs = {k: v.clone() for k, v in model.named_buffers()}
        y = _forward(model, model, args)
        cot = torch.randn(y.shape, generator=g, dtype=F64)
        ref = torch.autograd.grad((y * cot).sum(), params)
        ref_bufs = {k: v.clone() for k, v in model.named_buffers()}
        for k, v in model.named_buffers():
            v.copy_(bufs[k])

        block = S.check_supported(model, x.shape, n, axis, takes_mask, F64)
        layout = S.SpatialLayout([CPU] * n, axis, PADDED, PADDED, block)
        outs = _forward(model, S.ShardedStep(model, layout), [layout.split(a) for a in args])
        got = torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs, layout.split(cot))),
                                  params)
        whole = torch.cat(outs, 2 + axis).detach()
        what = f"{name} over {n} shards along axis {axis}"
        torch.testing.assert_close(whole, y.detach(), rtol=0,
                                   atol=TIGHT * float(y.detach().abs().max()), msg=what)
        if name == "dropout":   # the masks, bit for bit
            assert torch.equal(whole == 0, y.detach() == 0), what
        g_max = max(float(r.abs().max()) for r in ref)
        for (pname, _), a, b in zip(model.named_parameters(), got, ref):
            assert a is not None and bool(a.abs().max() > 0), f"{what}: {pname}"
            torch.testing.assert_close(a, b, rtol=0, atol=TIGHT * g_max, msg=f"{what}: {pname}")
        for k, v in model.named_buffers():
            torch.testing.assert_close(v, ref_bufs[k], rtol=0, atol=1e-14, msg=f"{what}: {k}")


class Strided(nn.Module):
    """``downs`` stride-2 convs, then a nearest resize back, and where
    ``body`` a MulResUnet of three levels (its own block 4) at the deepest
    resolution."""

    def __init__(self, downs: int, body: bool = False):
        super().__init__()
        self.downs = nn.ModuleList(nn.Conv2d(4, 4, 3, stride=2, padding=1)
                                   for _ in range(downs))
        c = Config(datadim="2d", inputdepth=4, filters=[4, 4, 4], skip=[4, 4])
        self.body = get_net(c, 4) if body else None
        self.head = nn.Conv2d(4, 1, 1)

    def forward(self, x):
        h = x
        for conv in self.downs:
            h = conv(h)
        if self.body is not None:
            h = self.body(h)
        return self.head(F.interpolate(h, scale_factor=2 ** len(self.downs)))


@pytest.mark.parametrize("model,shape,n,block", [
    (lambda: Strided(3), (32, 16), 2, 8),
    (lambda: Strided(1, body=True), (32, 16), 4, 8),
    (lambda: Strided(4), (48, 16), 2, 16),
])
def test_the_meta_pass_finds_the_shard_block(model, shape, n, block):
    """2^S for S stride-2 steps (three convs: 8); a MulResUnet's block 4
    met at half resolution: 8; four convs over an axis of 48 planes, whose
    widest 2-shard block of 24 planes a fourth stride does not divide: the
    pass retries on 16-plane blocks. Nothing is drawn (the generator's
    state stays), and a solve on that block runs."""
    net = model()
    state = torch.get_rng_state()
    assert S.check_supported(net, (1, 4) + shape, n, 0) == block
    assert torch.equal(torch.get_rng_state(), state)
    img = np.ones(shape + (1,), np.float32)
    cfg = Config(datadim="2d", epochs=1, inputdepth=4, filters=[4, 8], skip=[4], gain=1.0)
    got = DIPSolver(cfg, device="cpu", model=model()).solve(img, img, spatial_mesh=[CPU] * n,
                                                           spatial_axis=0)
    assert np.isfinite(got.history.loss).all()


class Caller(nn.Module):
    """The 2D caller of tests/test_torch_spatial_custom_jax.py: a MulResUnet
    body, a conv, a spatial mean into a ``Linear``, a pool, an upsample."""

    def __init__(self, cfg):
        super().__init__()
        self.body = get_net(cfg, 1)
        self.pre = nn.Conv2d(cfg.inputdepth, 4, 3, padding=1)
        self.gate = nn.Linear(4, 4)
        self.head = nn.Conv2d(4, 1, 1)
        self.scale = nn.Parameter(torch.tensor(0.5))

    def forward(self, x):
        h = F.leaky_relu(self.pre(x), 0.2)
        h = h * torch.sigmoid(self.gate(h.mean(dim=(2, 3))))[:, :, None, None]
        h = upsample(F.avg_pool2d(h, 2), 2, "bilinear")
        return self.body(x) + self.scale * self.head(h)


def _patch(nt=24, nx=32):
    rng = np.random.RandomState(0)
    t = np.linspace(0, 1, nt)[:, None]
    x = np.linspace(0, 1, nx)[None, :]
    img = np.sin(2 * np.pi * (3 * t + 2 * x)).astype(np.float32)[..., None]
    mask = np.repeat((rng.rand(1, nx) > 0.5).astype(np.float32), nt, 0)[..., None]
    return img, mask


class Gated(nn.Module):
    """A library component that makes its children at its first call (the
    CBAM gates) inside a caller's module: the solver builds it before
    anything is drawn, and its walk takes it."""

    def __init__(self, cfg):
        super().__init__()
        self.cbam = CBAM(2)
        self.head = nn.Conv2d(cfg.inputdepth, 1, 3, padding=1)

    def forward(self, x):
        return self.head(self.cbam(x))


@pytest.mark.parametrize("make,n,axis", [(Caller, 2, 0), (Caller, 4, 1), (Gated, 2, 1)])
def test_a_solve_of_a_callers_module_follows_the_unsharded_one(make, n, axis, monkeypatch):
    """``DIPSolver(model=...).solve(spatial_mesh=[cpu] * n)``: the float32
    losses of 3 iterations to rtol 1e-5, the output within 1e-5 of its max;
    the meta pass runs before anything is drawn."""
    cfg = Config(datadim="2d", epochs=3, scan_chunk=3, inputdepth=4, gain=1.0,
                 filters=[4, 8, 8], skip=[4, 4], upsample="linear")
    img, mask = _patch()

    def solve(**kw):
        torch.manual_seed(1)
        return DIPSolver(cfg, device="cpu", model=make(cfg)).solve(img, mask, seed=0, **kw)
    ref = solve()
    order = []
    real_pass, real_gens = S.check_supported, E._generators
    monkeypatch.setattr(S, "check_supported",
                        lambda *a: order.append("meta") or real_pass(*a))
    monkeypatch.setattr(E, "_generators", lambda *a: order.append("draw") or real_gens(*a))
    got = solve(spatial_mesh=[CPU] * n, spatial_axis=axis)
    assert order == ["meta", "draw"]
    np.testing.assert_allclose(got.history.loss, ref.history.loss, rtol=1e-5)
    np.testing.assert_allclose(got.out_best, ref.out_best, rtol=0,
                               atol=1e-5 * float(np.abs(ref.out_best).max()))
