"""The interval collectives of uneven spatial shards (parallel/spatial.py)
on the CPU: ``relayout`` (shard i gets any interval of the whole's planes,
past the volume's ends as ``F.pad`` with each edge gives them; an empty
interval gives no planes), the windows of a stride-s op (``windows``: each
shard owns the output planes whose first input plane it holds), the
volume's max (``all_max``) and the loss sums (``ShardedStep.loss_terms``)
with shards that hold no planes. Forwards against slices of the padded
whole, backwards against autograd of the whole, in float64."""
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from deep_prior_interpolation_tpu_torch.ops import losses as L
from deep_prior_interpolation_tpu_torch.ops.fused_loss import fused_loss_sums, metrics_from_sums
from deep_prior_interpolation_tpu_torch.parallel import spatial as S

torch.set_num_threads(1)
CPU = torch.device("cpu")
F64 = torch.float64
EDGES = ("zero", "replicate", "reflect", "-inf")
# 12 planes as 5 shards, one of them empty
SIZES = (3, 0, 4, 1, 4)
# each output shard's interval: a halo past the start, a crop, an empty
# one, an interval that spans three shards, a halo past the end
TARGETS = ((-2, 4), (5, 7), (6, 6), (1, 11), (9, 15))


def _split(x, sizes, dim=3):
    return list(x.split(list(sizes), dim))


def _padded(x, lo, hi, edge):
    """``x`` padded along its last dim as ``F.pad`` pads it (-inf: a
    constant pad of -inf)."""
    if edge in ("zero", "-inf"):
        return F.pad(x, (lo, hi), value=0.0 if edge == "zero" else -float("inf"))
    return F.pad(x, (lo, hi, 0, 0), mode=edge)


@pytest.mark.parametrize("edge", EDGES)
def test_relayout_is_the_padded_whole_sliced(edge):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 2, 3, sum(SIZES), dtype=F64, generator=g)
    lo, hi = 2, 3
    pad = _padded(x, lo, hi, edge)
    xs = [t.clone().requires_grad_() for t in _split(x, SIZES)]
    outs = S.relayout(xs, 1, TARGETS, edge)
    for (a, b), o, t in zip(TARGETS, outs, xs):
        assert torch.equal(o, pad[..., a + lo:b + lo]) and o.device == t.device
    if edge == "-inf":   # no gradient flows through -inf planes
        return
    whole = x.clone().requires_grad_()
    ref_pad = _padded(whole, lo, hi, edge)
    gs = [torch.randn(o.shape, dtype=F64, generator=g) for o in outs]
    (dx,) = torch.autograd.grad(sum((ref_pad[..., a + lo:b + lo] * t).sum()
                                    for (a, b), t in zip(TARGETS, gs)), whole)
    got = torch.autograd.grad(outs, xs, gs, allow_unused=True)
    torch.testing.assert_close(torch.cat(got, 3), dx, rtol=1e-12, atol=1e-12)


def test_relayout_passes_gradcheck_with_an_empty_shard():
    g = torch.Generator().manual_seed(1)
    xs = [torch.randn(1, 1, 2, s, dtype=F64, generator=g).requires_grad_() for s in SIZES]
    assert torch.autograd.gradcheck(
        lambda *t: S._Relayout.apply(1, TARGETS, "replicate", *t), tuple(xs))


def test_relayout_onto_its_own_bounds_is_the_shards_and_a_halo_keeps_empties_empty():
    xs = _split(torch.randn(1, 1, 2, 12, dtype=F64), SIZES)
    bounds = S.bounds_of(xs, 3)
    assert bounds == [(0, 3), (3, 3), (3, 7), (7, 8), (8, 12)]
    assert all(a is b for a, b in zip(S.relayout(xs, 1, bounds), xs))
    outs = S.halo_exchange(xs, 1, 1, 2, "zero")
    assert [o.shape[3] for o in outs] == [6, 0, 7, 4, 7]


def test_owned_rounded_and_the_block_split():
    assert S.owned([(0, 3), (3, 3), (3, 7), (7, 8), (8, 12)], 2, 6) == \
        [(0, 2), (2, 2), (2, 4), (4, 4), (4, 6)]
    assert S.owned([(0, 4), (4, 5)], 2, 2) == [(0, 2), (2, 2)]   # a floor pool's 2 of 5
    assert S.rounded([(0, 3), (3, 5), (5, 8)], 2) == [(0, 4), (4, 6), (6, 8)]
    assert S.rounded([(0, 1), (1, 2), (2, 4)], 4) == [(0, 0), (0, 4), (4, 4)]
    assert S.shard_bounds(48, 2, 32) == [(0, 32), (32, 48)]
    assert S.shard_bounds(128, 10, 16) == [(0, 16), (16, 32), (32, 48), (48, 64), (64, 80),
                                           (80, 96), (96, 104), (104, 112), (112, 120),
                                           (120, 128)]


# (kernel, stride, padding before the volume, edge, the op on a window,
# the op on the whole): a stride-2 conv, a floor pool, a 1 x 1 stride-2
# conv, a -inf padded max pool, a Lanczos-like correlation over a
# replicate edge
def _conv(k, s, p):
    w = torch.randn(1, 2, k, 1, dtype=F64, generator=torch.Generator().manual_seed(k))
    return (lambda t: F.conv2d(t, w, stride=(s, 1))), \
        (lambda t: F.conv2d(F.pad(t, (0, 0, p, p)), w, stride=(s, 1)))


WINDOWS = {
    "conv3": (3, 2, 1, "zero", *_conv(3, 2, 1)),
    "pool2": (2, 2, 0, "zero", lambda t: F.avg_pool2d(t, (2, 1)),
              lambda t: F.avg_pool2d(t, (2, 1))),
    "conv1": (1, 2, 0, "zero", *_conv(1, 2, 0)),
    "maxpool3": (3, 2, 1, "-inf", lambda t: F.max_pool2d(t, (3, 1), (2, 1)),
                 lambda t: F.max_pool2d(t, (3, 1), (2, 1), padding=(1, 0))),
    "lanczos": (8, 2, 3, "replicate",
                lambda t: F.conv2d(t, torch.ones(1, 2, 8, 1, dtype=F64) / 16, stride=(2, 1)),
                lambda t: F.conv2d(F.pad(t, (0, 0, 3, 3), mode="replicate"),
                                   torch.ones(1, 2, 8, 1, dtype=F64) / 16, stride=(2, 1))),
}


@pytest.mark.parametrize("name", list(WINDOWS))
def test_each_shard_s_window_gives_the_outputs_it_owns(name):
    """13 planes as 5 shards (one empty, some starting on odd planes): the
    ceil and floor output counts."""
    k, s, p, edge, local, whole_op = WINDOWS[name]
    extent = 13
    g = torch.Generator().manual_seed(2)
    x = torch.randn(1, 2, extent, 3, dtype=F64, generator=g)
    y = whole_op(x)
    sizes = (3, 0, 4, 1, extent - 8)
    xs = [t.clone().requires_grad_() for t in _split(x, sizes, 2)]
    pieces, out = S.windows(xs, 0, k, s, p, edge, y.shape[2])
    assert out == S.owned(S.bounds_of(xs, 2), s, y.shape[2])
    ys = S.on_shards(lambda t, i: local(t), pieces, 2, [d - c for c, d in out])
    torch.testing.assert_close(torch.cat(ys, 2), y, rtol=1e-12, atol=1e-12)
    cot = torch.randn(y.shape, dtype=F64, generator=g)
    whole = x.clone().requires_grad_()
    (dx,) = torch.autograd.grad((whole_op(whole) * cot).sum(), whole)
    got = torch.autograd.grad(sum((a * b).sum() for a, b in zip(ys, _split(
        cot, [d - c for c, d in out], 2)) if a.requires_grad), xs, allow_unused=True)
    got = [torch.zeros_like(t) if d is None else d for t, d in zip(xs, got)]
    torch.testing.assert_close(torch.cat(got, 2), dx, rtol=1e-12, atol=1e-12)


def test_all_max_skips_the_shards_without_planes():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1, 2, 12, 2, dtype=F64, generator=g)
    x[0, 0, 9, 1] = x[0, 0, 2, 0] = 5.0   # a tie on two shards
    xs = [t.clone().requires_grad_() for t in _split(x, SIZES, 2)]
    outs = S.all_max(xs, (2, 3))
    whole = x.clone().requires_grad_()
    ref = torch.amax(whole, dim=(2, 3), keepdim=True)
    assert all(torch.equal(o, ref.detach()) for o in outs)
    cot = torch.randn(ref.shape, dtype=F64, generator=g)
    (dx,) = torch.autograd.grad((ref * cot).sum(), whole)
    got = torch.autograd.grad(sum((o * cot).sum() for o in outs[:1]), xs)
    torch.testing.assert_close(torch.cat(got, 2), dx, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("fused", [True, False])
def test_the_loss_sums_skip_the_shards_whose_crop_is_empty(fused):
    """(16, 10) planes in a (16, 16) canvas over 8 shards of 2 planes: the
    first and the last shard hold padding alone and have no sums."""
    g = torch.Generator().manual_seed(5)
    layout = S.SpatialLayout([CPU] * 8, 1, (16, 16), (16, 10))
    assert layout.crops[0] == (0, 0) and layout.crops[-1] == (10, 10)
    out = torch.randn(1, 1, 16, 16, dtype=torch.float32, generator=g)
    img = torch.randn(1, 1, 16, 10, generator=g)
    mask = (torch.rand(1, 1, 16, 10, generator=g) > 0.4).float()
    data = {"img": layout.split(img, cropped=True), "mask": layout.split(mask, cropped=True)}
    step = S.ShardedStep(torch.nn.Linear(1, 1), layout)
    s = SimpleNamespace(fused_loss=fused, loss="mae")
    outs, main, ys = step.loss_terms(layout.split(out), data, s, torch.float32, CPU)
    assert [o.shape[3] for o in outs] == [0, 1, 2, 2, 2, 2, 1, 0]
    crop = out[..., 3:13]
    if fused:
        want, mets = metrics_from_sums(fused_loss_sums(crop, img, mask), float(crop.numel()),
                                       "mae")
    else:
        want = L.masked_fit([crop], [img], [mask], "mae")
        mets = L.snr_pcorr([crop], [img])
    torch.testing.assert_close(main, want, rtol=1e-6, atol=0)
    for k in ("snr", "pcorr"):
        torch.testing.assert_close(ys[k], mets[k].detach(), rtol=1e-5, atol=0)
