"""The zoo nets over spatial shards: ``ShardedStep``'s walks of the skip
net, the U-Net, the partial-conv U-Net and the attention MultiRes U-Net
(``parallel/spatial.py`` walks the MulResUnet).

Each walk mirrors its net's ``forward`` over the list of shards with the
step's shared pieces (``ShardedStep._conv``, ``_norm``, ``_drop``,
``_upsample``, ``_multires``) and reads the net's children in the order
its forward asks for them (``Compact._order``), so the parameters, their
names and the dropout draws are the plain net's. A shard holds a whole
number of the net's blocks (``engine.solver.shard_block``: 2^S planes for S
stride-2 steps), so every level halves each shard exactly and a
``concat_crop`` or ``_crop_front`` leaves the sharded axis alone: the walks
check that, and crop the other axes per shard as the plain net crops them.

What is new beside the MulResUnet's pieces:

  * the U-Net's ``InstanceNorm`` takes two all-reduces: the float32 sum for
    the mean, then the float32 sum of squared deviations from it (the
    plain net's two-pass population variance); its 2x pools are local;
  * the partial conv's own conv is flax's ``nn.Conv`` (``FlaxConv``): it
    runs through ``F.conv*`` over a zero halo of (k - 1) / 2 planes,
    unpadded along the axis, so its weight gradient stays with cuDNN as in
    the plain net; the window sum of the mask's channel sum takes the same
    halo before its unpadded pool; the division, the holes and the new
    mask are local;
  * the attention gate's map is a one-channel bilinear x2 upsample over
    the resize's replicate halo, whatever the net's own upsample mode.

``uncovered`` names what no walk covers yet (ROADMAP A.13c item 12): a
class outside the five, and the constructor options ``get_net`` never
sets: the skip net's reflection padding, Lanczos downsampling and even
kernel sizes, the U-Net's deconv up path, ``concat_x`` and ``more_layers``.
The skip net's per-scale mode lists and its avg and max pool downsampling
are covered (the pools are local on whole blocks).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..models.attention import AttMulResUnet, GridAttentionBlock, _crop_front
from ..models.blocks import FlaxConv, _bcast, _promoted, concat_crop, downsample_pool
from ..models.mulresunet import MulResUnet
from ..models.partial import PartialBlock, PartialConv, PartialUNet
from ..models.skip import SkipNet, _per_scale
from ..models.unet import InstanceNorm, UNet, UNetConv, _pool
from .spatial import ShardedStep, all_reduce, halo_exchange

__all__ = ["uncovered", "walk"]

Shards = List[torch.Tensor]


def uncovered(model: nn.Module) -> Optional[str]:
    """What of ``model`` no sharded walk covers (ROADMAP A.13c item 12), as
    the constructor call that made it; None where a walk covers it."""
    if isinstance(model, (MulResUnet, PartialUNet, AttMulResUnet)):
        return None
    if isinstance(model, SkipNet):
        n = len(model.filters)
        if model.pad != "zero":
            return f"SkipNet(pad={model.pad!r})"
        downs = _per_scale(model.downsample_mode, n)
        if any(d not in ("stride", "avg", "max") for d in downs):
            return f"SkipNet(downsample_mode={model.downsample_mode!r})"
        sizes = (_per_scale(model.filter_size_down, n) + _per_scale(model.filter_size_up, n)
                 + [model.filter_skip_size])
        if any(k % 2 == 0 for k in sizes):
            return (f"SkipNet(filter_size_down={model.filter_size_down!r}, filter_size_up="
                    f"{model.filter_size_up!r}, filter_skip_size={model.filter_skip_size})")
        return None
    if isinstance(model, UNet):
        if model.upsample_mode == "deconv":
            return "UNet(upsample_mode='deconv')"
        if model.concat_x or model.more_layers:
            return f"UNet(concat_x={model.concat_x}, more_layers={model.more_layers})"
        return None
    return type(model).__name__


def walk(step: ShardedStep, xs: Shards, masks: Optional[Shards] = None) -> Shards:
    """The output shards of ``step.model``, a zoo net, for the input shards
    ``xs`` (and the partial-conv U-Net's mask shards ``masks``)."""
    m = step.model
    if isinstance(m, SkipNet):
        return _skip(step, m, xs)
    if isinstance(m, UNet):
        return _unet(step, m, xs)
    if isinstance(m, PartialUNet):
        return _partial(step, m, xs, masks)
    if isinstance(m, AttMulResUnet):
        return _attention(step, m, xs)
    raise NotImplementedError(f"a spatially sharded solve of {type(m).__name__}: "
                              f"ROADMAP A.13c item 12")


def _children(m: nn.Module) -> Callable[[], nn.Module]:
    """The next child of a built ``Compact`` module at each call, in the
    order its forward asks for them."""
    names = iter(m._order)
    return lambda: getattr(m, next(names))


def _whole_axis(step: ShardedStep, groups: Sequence[Shards]) -> None:
    """Check that each shard of ``groups`` has one extent along the sharded
    axis: whole blocks leave no level there to crop."""
    dim = step.layout.dim
    for ts in zip(*groups):
        if len({t.shape[dim] for t in ts}) != 1:
            raise RuntimeError(f"shards of {[tuple(t.shape) for t in ts]} differ along the "
                               f"sharded axis: a shard holds whole blocks of the net")


def _cat(step: ShardedStep, groups: Sequence[Shards]) -> Shards:
    """``concat_crop`` of each shard's tensors: a plain concat along the
    sharded axis, the plain net's centre crop along the others."""
    _whole_axis(step, groups)
    return [concat_crop(ts) for ts in zip(*groups)]


def _act_drop(step: ShardedStep, m, act, xs: Shards) -> Shards:
    return step._drop(m.drop, [act(t) for t in xs])


# -- the skip net ------------------------------------------------------------

def _skip(step: ShardedStep, m: SkipNet, xs: Shards) -> Shards:
    """``SkipNet.forward`` over the shards."""
    nxt = _children(m)
    n = len(m.filters)
    skip_ch = list(m.skip)
    while len(skip_ch) < n:
        skip_ch.append(skip_ch[-1] if skip_ch else 4)
    ups = _per_scale(m.upsample_mode, n)
    downs = _per_scale(m.downsample_mode, n)

    def conv_block(h: Shards, stride: int = 1, down: str = "stride") -> Shards:
        if stride != 1 and down != "stride":   # a stride-1 conv, then a local pool
            return [downsample_pool(t, stride, down) for t in step._conv(nxt(), h)]
        return step._conv(nxt(), h)

    def norm(h: Shards) -> Shards:
        return step._norm(nxt(), h)

    def cna(h: Shards) -> Shards:
        return _act_drop(step, m, m.act, norm(h))

    def level(i: int, h: Shards) -> Shards:
        s = cna(conv_block(h)) if skip_ch[i] != 0 else None
        d = cna(conv_block(h, 2, downs[i]))
        d = cna(conv_block(d))
        if i < n - 1:
            d = level(i + 1, d)
        d = step._upsample(d, ups[i])
        y = _cat(step, [s, d]) if s is not None else d
        y = cna(conv_block(norm(y)))
        if m.need1x1_up:
            y = cna(conv_block(y))
        return y

    return [m.last_act(t) for t in conv_block(level(0, xs))]


# -- the U-Net ---------------------------------------------------------------

def _instance_norm(m: InstanceNorm, xs: Shards) -> Shards:
    """``InstanceNorm`` of the whole volume: the mean from the shards'
    float32 sums all-reduced, then the population variance from their
    float32 sums of squared deviations from it, each rounded to the
    input's dtype."""
    axes = tuple(range(2, xs[0].ndim))
    count = float(sum(x[0, 0].numel() for x in xs))
    xfs = [x.float() for x in xs]
    means = [s / count for s in all_reduce([xf.sum(dim=axes, keepdim=True) for xf in xfs])]
    sqs = all_reduce([((xf - mu) ** 2).sum(dim=axes, keepdim=True)
                      for xf, mu in zip(xfs, means)])
    return [(x - mu.to(x.dtype)) / torch.sqrt((sq / count).to(x.dtype) + m.eps)
            for x, mu, sq in zip(xs, means, sqs)]


def _unet_conv(step: ShardedStep, m: UNetConv, xs: Shards) -> Shards:
    nxt = _children(m)
    for _ in range(2):
        xs = step._conv(nxt(), xs)
        if m.norm:
            xs = _instance_norm(m.inorm, xs)
        xs = _act_drop(step, m, m.act, xs)
    return xs


def _unet(step: ShardedStep, m: UNet, xs: Shards) -> Shards:
    """``UNet.forward`` over the shards (no ``concat_x``, no
    ``more_layers``, an upsample-and-conv up path)."""
    nxt = _children(m)
    h = _unet_conv(step, nxt(), xs)
    skips = [h]
    for _ in range(1, 5):
        h = step._drop(m.drop, [_pool(t, "max") for t in h])
        h = step._drop(m.drop, _unet_conv(step, nxt(), h))
        skips.append(h)
    up = skips[-1]
    for i in range(4, 0, -1):
        up = step._conv(nxt(), step._upsample(up, m.upsample_mode))
        up = _unet_conv(step, nxt(), _cat(step, [up, skips[i - 1]]))
        up = step._drop(m.drop, up)
    return [m.last_act(t) for t in step._conv(nxt(), up)]


# -- the partial-conv U-Net --------------------------------------------------

def _flax_conv(step: ShardedStep, m: FlaxConv, xs: Shards) -> Shards:
    """``FlaxConv`` of stride 1 (the partial conv's) on the shards:
    ``F.conv*`` in the promoted dtype over a zero halo of its padding,
    unpadded along the axis, so its weight gradient is cuDNN's, as in the
    plain net."""
    ax, p, nd = step.layout.axis, m.padding, xs[0].ndim - 2
    dt = _promoted(xs[0])
    xs = [x.to(dt) for x in xs]
    if p:
        xs = halo_exchange(xs, ax, p, p, "zero")
    pads = tuple(0 if d == ax else p for d in range(nd))
    conv = (F.conv1d, F.conv2d, F.conv3d)[nd - 1]
    biases = step._rep(m.bias) if m.bias is not None else [None] * len(xs)
    return [conv(x, w.to(dt), None if b is None else b.to(dt), stride=1, padding=pads)
            for x, w, b in zip(xs, step._rep(m.kernel), biases)]


def _window_sums(step: ShardedStep, ms: Shards, k: int, p: int) -> Shards:
    """The partial conv's window sum (``partial._window_sum``, stride 1) of
    each shard over a zero halo of ``p`` planes, unpadded along the axis."""
    ax, nd = step.layout.axis, ms[0].ndim - 2
    if p:
        ms = halo_exchange(ms, ax, p, p, "zero")
    pads: List[int] = []
    for d in reversed(range(nd)):   # F.pad lists the last dim first
        pads += [0, 0] if d == ax else [p, p]
    pool = (F.avg_pool2d, F.avg_pool3d)[nd - 2]
    return [pool(F.pad(t, pads), k, 1, divisor_override=1) for t in ms]


def _partial_conv(step: ShardedStep, m: PartialConv, xs: Shards, masks: Shards):
    """``PartialConv.forward`` of stride 1 (``PartialBlock``'s) over the
    shards: the outputs and the new mask shards."""
    nxt = _children(m)
    k, p = m.kernel_size, (m.kernel_size - 1) // 2
    outs = _flax_conv(step, nxt(), [x * mk for x, mk in zip(xs, masks)])
    counts = _window_sums(step, [mk.sum(dim=1, keepdim=True) for mk in masks], k, p)
    biases = step._rep(m.bias) if m.use_bias else [None] * len(xs)
    ys, new_masks = [], []
    for x, out, c, b in zip(xs, outs, counts, biases):
        holes = c == 0
        out = out / torch.where(holes, torch.ones_like(c), c)
        if b is not None:
            out = out + _bcast(b.to(x.dtype), out.ndim)
        ys.append(torch.where(holes, torch.zeros((), dtype=out.dtype, device=out.device), out))
        new_masks.append((~holes).to(x.dtype).expand(out.shape))
    if m.use_norm:
        ys = step._norm(nxt(), ys)
    return _act_drop(step, m, m.act, ys), new_masks


def _partial_block(step: ShardedStep, m: PartialBlock, xs: Shards, masks: Shards):
    """``PartialBlock.forward``: the partial conv, then one stride-2 conv
    of the features and of the mask, each dropped out with its own draw."""
    nxt = _children(m)
    xs, masks = _partial_conv(step, nxt(), xs, masks)
    down = nxt()
    xs, masks = step._conv(down, xs), step._conv(down, masks)
    return step._drop(m.drop, xs), step._drop(m.drop, masks)


def _partial(step: ShardedStep, m: PartialUNet, xs: Shards, masks: Shards) -> Shards:
    """``PartialUNet.forward`` over the shards; ``masks`` are the shards of
    the solver's net mask."""
    if masks is None:
        raise ValueError("the partial-conv U-Net takes the mask's shards")
    nxt = _children(m)
    downs, h, k = [], xs, masks
    for _ in range(5):
        h, k = _partial_block(step, nxt(), h, k)
        downs.append(h)

    def dec(h: Shards) -> Shards:
        h = step._conv(nxt(), h)
        h = step._conv(nxt(), h)
        return step._drop(m.drop, step._upsample(h, "nearest"))

    up = step._upsample(downs[4], "nearest")
    for skip in (downs[3], downs[2], downs[1], downs[0]):
        up = dec(_cat(step, [skip, up]))
    h = _cat(step, [xs, up])
    for _ in range(4):
        h = step._conv(nxt(), h)
    return h


# -- the attention MultiRes U-Net --------------------------------------------

def _front(step: ShardedStep, a: Shards, b: Shards):
    """Each shard pair cropped to its smaller grid from the front
    (``_crop_front``), which whole blocks leave alone along the axis."""
    _whole_axis(step, [a, b])
    sps = [[min(u, v) for u, v in zip(s.shape[2:], t.shape[2:])] for s, t in zip(a, b)]
    return ([_crop_front(s, sp) for s, sp in zip(a, sps)],
            [_crop_front(t, sp) for t, sp in zip(b, sps)])


def _grid_attention(step: ShardedStep, m: GridAttentionBlock, g: Shards,
                    x: Shards) -> Shards:
    """``GridAttentionBlock.forward`` over the shards: the map's bilinear x2
    upsample over the resize's replicate halo."""
    nxt = _children(m)
    conv = nxt()
    g1 = step._norm(nxt(), step._conv(conv, g))
    conv = nxt()
    x1 = step._norm(nxt(), step._conv(conv, x))
    g1, x1 = _front(step, g1, x1)
    psi = [F.relu(a + b) for a, b in zip(g1, x1)]
    psi = [torch.sigmoid(t) for t in step._conv(nxt(), psi)]
    xs, psi = _front(step, x, step._upsample(psi, "bilinear"))
    return [a * b for a, b in zip(xs, psi)]


def _attention(step: ShardedStep, m: AttMulResUnet, xs: Shards) -> Shards:
    """``AttMulResUnet.forward`` over the shards."""
    nxt = _children(m)
    n = len(m.filters)
    feats: List[Shards] = []
    h = xs
    for i in range(n):
        if i > 0:
            h = step._conv(nxt(), h)
            h = _act_drop(step, m, m.act, step._norm(nxt(), h))
        h = step._multires(nxt(), h)
        feats.append(h)
    for i in range(1, n):
        g, s = feats[-i], feats[-(i + 1)]
        att = _grid_attention(step, nxt(), g, s)
        h = _cat(step, [att, step._upsample(g, m.upsample_mode)])
        h = step._multires(nxt(), h)
        feats[-(i + 1)] = h
    return [m.last_act(t) for t in step._conv(nxt(), h)]
