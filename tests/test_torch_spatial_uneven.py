"""Spatial shards that do not lie on the net's blocks (parallel/spatial.py,
spatial_zoo.py, spatial_custom.py; ROADMAP A.13d): each walk against its
unsharded net in float64 on the CPU, forward and every parameter gradient
of ``sum(out * cot)``, where the axis is not a whole number of at least N
of the net's blocks and ``shard_bounds`` splits it on a narrower
power-of-two block, as GSPMD shards unevenly.

The cases: the MulResUnet, 2D and 3D, over more shards than it has blocks
(some shards hold no plane at its deepest levels); the skip net and the
partial-conv U-Net on an axis of 16 x 3 planes (their blocks are 32) over
2 and 3 shards, their concats cropping along the axis; the U-Net over 4
shards of a 3-block axis (its deepest level has a shard without planes);
a small CBAM U-Net and a small ConvGRU ensemble; the phase net over 8
shards of 16 planes; a module of the caller's own with a strided conv, a
pool and a concat of two lists split otherwise. Dropout's masks are the
unsharded draw, bit for bit, with shards that hold no plane.

Tolerances, of the largest output and of the largest gradient: 1e-12,
beside the nets whose own statistics or conditioning test_torch_spatial_zoo_
options.py measured: the U-Net's InstanceNorm takes float32 statistics, as
in the plain net (1e-6 and 1e-9), the CBAM U-Net and the ensemble (1e-11
and 2e-10). No gradient is missing, nor all zeros where the unsharded
one is not at rounding level (a conv's bias before a Norm)."""
import pytest
import torch
from torch import nn

from deep_prior_interpolation_tpu_torch import Config
from deep_prior_interpolation_tpu_torch.engine.solver import shard_block
from deep_prior_interpolation_tpu_torch.models import (AttentionUnet, Ensemble, PartialUNet,
                                                      SkipNet, UNet, get_net, init_weights,
                                                      set_dropout_generator)
from deep_prior_interpolation_tpu_torch.models.blocks import Conv, Dropout, upsample
from deep_prior_interpolation_tpu_torch.parallel import spatial as S

torch.set_num_threads(1)
CPU = torch.device("cpu")
F64 = torch.float64
TIGHT, INORM, CBAM_TOL, GRU_TOL = (1e-12, 1e-12), (1e-6, 1e-9), (1e-11, 1e-11), (2e-10, 2e-10)


def _mulresunet(ndim: int, **kw):
    filters = [4, 8, 8, 8] if ndim == 2 else [4, 8, 8]
    c = Config(datadim=f"{ndim}d", inputdepth=4, filters=filters, skip=[4] * (len(filters) - 1),
               upsample="linear", dropout=0.1, **kw)
    return get_net(c, 1), c


def walked(model, padded, n, axis=1, tol=TIGHT, block=None, mask=False, cfg=None):
    """``model`` in float64 over ``n`` shards of ``padded`` along ``axis``
    against the unsharded net: the forward and every parameter gradient of
    ``sum(out * cot)`` to ``tol`` of the largest, none missing or zero.
    Returns the layout."""
    model = model.double()
    init_weights(model, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(4)
    x = torch.randn((1, 4) + tuple(padded), generator=g, dtype=F64)
    args = [x]
    if mask:
        args.append((torch.rand(x.shape, generator=g) > 0.4).to(F64))
    params = list(model.parameters())
    set_dropout_generator(model, torch.Generator().manual_seed(9))
    y = model(*args)
    cot = torch.randn(y.shape, generator=g, dtype=F64)
    ref = torch.autograd.grad((y * cot).sum(), params)
    if block is None:
        block = shard_block(cfg or Config(), model)
    layout = S.SpatialLayout([CPU] * n, axis, padded, padded, block)
    set_dropout_generator(model, torch.Generator().manual_seed(9))
    outs = S.ShardedStep(model, layout)(*[layout.split(a) for a in args])
    got = torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs, layout.split(cot))),
                              params, allow_unused=True)
    assert [o.shape[2 + axis] for o in outs] == [b - a for a, b in layout.bounds]
    whole = torch.cat(outs, 2 + axis).detach()
    y = y.detach()
    assert float((whole - y).abs().max()) <= tol[0] * float(y.abs().max())
    g_max = max(float(r.abs().max()) for r in ref)
    for (name, _), a, b in zip(model.named_parameters(), got, ref):
        assert a is not None, name
        # zero only where the unsharded one is at rounding level (a conv's
        # bias before a Norm)
        assert bool(a.abs().max() > 0) or float(b.abs().max()) <= tol[1] * g_max, name
        assert float((a - b).abs().max()) <= tol[1] * g_max, name
    return layout


def _deepest(layout, levels: int):
    """The shard extents at ``levels`` stride-2 steps below the layout's."""
    bounds = layout.bounds
    for _ in range(levels):
        bounds = S.owned(bounds, 2, -(-bounds[-1][1] // 2))
    return [b - a for a, b in bounds]


def test_the_2d_mulresunet_over_more_shards_than_blocks():
    net, c = _mulresunet(2)
    layout = walked(net, (16, 24), 5, cfg=c)
    # 24 planes hold 3 of its 8-plane blocks: 5 shards on 4-plane blocks
    assert layout.bounds == [(0, 8), (8, 12), (12, 16), (16, 20), (20, 24)]
    assert _deepest(layout, 3) == [1, 1, 0, 1, 0]


def test_the_3d_mulresunet_over_more_shards_than_blocks():
    net, c = _mulresunet(3)
    layout = walked(net, (8, 12, 8), 5, cfg=c)
    assert _deepest(layout, 2) == [1, 1, 0, 1, 0]


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("net", ["skip", "part"])
def test_a_net_of_32_plane_blocks_on_48_planes(net, n):
    """5 stride-2 steps: 48 planes down to 3, then 2 (the conv's ceil),
    upsampled to 4 and cropped to 3 by the concat, along the sharded axis."""
    if net == "skip":
        model = SkipNet(4, 1, 2, (4, 4, 4, 4, 4), (2, 2, 2, 2, 2), upsample_mode="bilinear",
                        dropout=0.1)
    else:
        model = PartialUNet(4, 1, 2, dropout=0.1)
    layout = walked(model, (48, 16), n, axis=0, mask=net == "part")
    assert shard_block(Config(), model) == 32
    assert layout.bounds == ([(0, 32), (32, 48)] if n == 2 else [(0, 16), (16, 32), (32, 48)])


def test_the_unet_over_4_shards_of_a_3_block_axis():
    layout = walked(UNet(4, 1, 2, (4, 4, 4, 4, 4), upsample_mode="bilinear"), (16, 48), 4,
                    tol=INORM)
    assert layout.bounds == [(0, 16), (16, 32), (32, 40), (40, 48)]
    assert _deepest(layout, 4)[-1] == 0


def test_a_small_cbam_unet_over_uneven_shards():
    walked(AttentionUnet(4, att="cbam"), (16, 48), 4, tol=CBAM_TOL)


def test_a_small_ensemble_over_uneven_shards():
    walked(Ensemble(4, 1, num_frames=1, hidden=8), (32, 96), 4, tol=GRU_TOL)


def test_the_phase_net_over_8_shards_of_16_planes():
    c = Config(datadim="2d", inputdepth=4, filters=[4, 8, 8], skip=[4, 4], phase_space=True,
               phase_levels=-1, phase_deep_levels=1, upsample="linear")
    layout = walked(get_net(c, 1), (16, 16), 8, cfg=c)
    assert layout.bounds == [(2 * i, 2 * i + 2) for i in range(8)]


class Strided(nn.Module):
    """A module of the caller's own: a stride-2 conv and a 2 x 2 pool (each
    shard's outputs by the owner rule), their concat, the port's upsample
    back (on the doubled bounds) and its concat with the input (on the
    input's bounds, relaid onto the upsample's)."""

    def __init__(self):
        super().__init__()
        self.down = nn.Conv2d(4, 4, 3, stride=2, padding=1)
        self.mix = Conv(8, 4, 3)
        self.head = nn.Conv2d(8, 1, 3, padding=1)

    def forward(self, x):
        a = torch.relu(self.down(x))
        b = nn.functional.avg_pool2d(x, 2)
        u = upsample(self.mix(torch.cat([a, b], 1)), 2, "bilinear")
        return self.head(torch.cat([u, x], 1))


def test_a_callers_module_with_strides_and_a_concat_of_other_bounds():
    """10 planes over 7 shards: the strides' block of 2 gives 5, so the
    shards lie on single planes, some starting on odd ones."""
    model = Strided().double()
    assert S.check_supported(model, (1, 4, 12, 10), 7, 1, False, F64) == 2
    layout = walked(model, (12, 10), 7, block=2)
    assert layout.bounds == [(0, 2), (2, 4), (4, 6), (6, 7), (7, 8), (8, 9), (9, 10)]


def test_dropout_masks_are_the_unsharded_draw_with_empty_shards():
    drop = Dropout(0.5)
    x = torch.randn(1, 3, 4, 8, dtype=F64)
    set_dropout_generator(drop, torch.Generator().manual_seed(2))
    ref = drop(x)
    layout = S.SpatialLayout([CPU] * 3, 1, (4, 8), (4, 8))
    step = S.ShardedStep(drop, layout)
    set_dropout_generator(drop, torch.Generator().manual_seed(2))
    xs = layout.split(x)
    xs = [xs[0], xs[1][:, :, :, :0], torch.cat([xs[1], xs[2]], 3)]   # a shard of no planes
    got = step._drop(drop, xs)
    assert got[1].shape[3] == 0
    assert torch.equal(torch.cat(got, 3), ref)


@pytest.mark.parametrize("block", [1, 2, 4, 16, 32])
def test_shard_bounds_keep_the_block_aligned_split(block):
    """Where the axis is a whole number of at least N blocks, the bounds are
    the block-aligned split of whole blocks, the first shards one block
    more, as before uneven shards."""
    for blocks in range(1, 13):
        for n in range(1, blocks + 1):
            base, extra = divmod(blocks, n)
            want, a = [], 0
            for i in range(n):
                want.append((a, a + (base + (i < extra)) * block))
                a = want[-1][1]
            assert S.shard_bounds(blocks * block, n, block) == want
