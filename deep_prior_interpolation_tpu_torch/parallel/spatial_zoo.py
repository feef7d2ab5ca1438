"""The zoo nets over spatial shards: ``ShardedStep``'s walks of the skip
net, the U-Net, the partial-conv U-Net, the attention MultiRes U-Net, the
CBAM U-Net and the ConvGRU ensemble, and of the library's blocks given to
the solver alone (``parallel/spatial.py`` walks the MulResUnet).

Each walk mirrors its net's ``forward`` over the list of shards with the
step's shared pieces (``ShardedStep._conv``, ``_norm``, ``_drop``,
``_upsample``, ``_multires``) and reads the net's children in the order
its forward asks for them (``Compact._order``), so the parameters, their
names and the dropout draws are the plain net's. Each stride-2 op (a
strided conv, a pool, a Lanczos pass, the ensemble's stem pool) gives each
shard the output planes whose first input plane it holds and reads their
window (``spatial.windows``); an upsample or a deconv doubles its input's
bounds; a ``concat_crop`` or ``_crop_front`` relays each tensor onto the
first smallest one's bounds, its crop along the axis included
(``spatial.relayout``), and crops the other axes per shard as the plain
net crops them. Where the shards lie on whole blocks of the net
(``engine.solver.shard_block``: 2^S planes for S stride-2 steps) every
level halves each shard exactly and no relayout runs. A window may reach
past the neighbouring shard (each plane comes from whichever shard holds
it): at a net's deepest levels a shard holds a plane or two, or none.

What is new beside the MulResUnet's pieces:

  * the U-Net's ``InstanceNorm`` takes two all-reduces: the float32 sum for
    the mean, then the float32 sum of squared deviations from it (the
    plain net's two-pass population variance); its 2x pools and the
    ``concat_x`` input pyramid are local; its deconv up path
    (``ConvTranspose``, k = 4, stride 2) takes a zero halo of one input
    plane on each side and crops two output planes on each side;
  * the partial conv's own conv is flax's ``nn.Conv`` (``FlaxConv``): it
    runs through ``F.conv*`` over a zero halo of (k - 1) / 2 planes,
    unpadded along the axis, so its weight gradient stays with cuDNN as in
    the plain net; the window sum of the mask's channel sum takes the same
    halo before its unpadded pool; the division, the holes and the new
    mask are local; the ConvGRU cell's three gates are such convs too;
  * the attention gate's map is a one-channel bilinear x2 upsample over
    the resize's replicate halo, whatever the net's own upsample mode;
  * the skip net's reflection padding takes a reflect halo
    (``ShardedStep._conv``); its Lanczos downsampling a replicate halo of
    3 (``lanczos2``) or 5 (``lanczos3``) planes before the pass along the
    axis (``lanczos_pass``), the other axes padded locally;
  * CBAM's channel gate takes the volume's mean (an all-reduce of float32
    sums) and its max (``all_max``, whose backward splits the cotangent
    over the tied voxels of the whole volume); its spatial gate's 7 x 7
    conv a zero halo of 3 planes;
  * the ensemble's stem max pool (3, stride 2, padding 1) reads its window
    over a -inf edge at the volume's start.

``covered_class`` names the class whose walk covers a net (a subclass that
keeps its base's forward takes its base's walk); a module of the caller's
own runs on ``spatial_custom``'s walker, which dispatches the library nets
it calls to these walks. Every constructor option of the
library's nets is covered; a net whose output is not the solver's
``(1, outchannel, *padded)`` (a skip net with even kernel sizes, an
ensemble of several frames) is refused, sharded or not, by
``engine.solver.check_net_output`` first.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..models.attention import (CBAM, AttentionUnet, AttMulResUnet, ChannelGate,
                                GridAttentionBlock, SpatialGate, _crop_front)
from ..models.blocks import (Conv, ConvNormAct, ConvTranspose, FlaxConv, Norm, _bcast,
                             _promoted, concat_crop, downsample_pool, lanczos_halo,
                             lanczos_pass)
from ..models.convgru import ConvGRUCell, Decoder, Encoder, Ensemble, ResNetBasicBlock
from ..models.mulresunet import MulResUnet, MultiResBlock, ResPath
from ..models.partial import PartialBlock, PartialConv, PartialUNet
from ..models.skip import SkipNet, _per_scale
from ..models.unet import InstanceNorm, UNet, UNetConv, _pool
from .spatial import (ShardedStep, all_max, all_reduce, bounds_of, halo_exchange, on_shards,
                      relayout, windows)

__all__ = ["uncovered", "walk"]

Shards = List[torch.Tensor]


def covered_class(model: nn.Module) -> Optional[type]:
    """The class whose sharded walk covers ``model``: its own, or the
    nearest base with a walk whose ``forward`` it keeps (a subclass that
    does not override it); None for any other module, a module of the
    caller's own (``spatial_custom`` runs its forward on the shards)."""
    for cls in type(model).__mro__:
        if cls is MulResUnet or cls in _WALKS:
            return cls if type(model).forward is cls.forward else None
    return None


def uncovered(model: nn.Module) -> Optional[str]:
    """The class of ``model`` where no walk covers it (a module of the
    caller's own, which ``spatial_custom``'s walker runs); None where one
    does."""
    return None if covered_class(model) is not None else type(model).__name__


def walk(step: ShardedStep, xs: Shards, masks: Optional[Shards] = None) -> Shards:
    """The output shards of ``step.model``, a zoo net or a library block
    (or a subclass that keeps its forward), for the input shards ``xs``
    (and the partial-conv U-Net's mask shards ``masks``)."""
    m = step.model
    fn = _WALKS[covered_class(m)]
    if isinstance(m, PartialUNet):
        return fn(step, m, xs, masks)
    return fn(step, m, xs)


def _children(m: nn.Module) -> Callable[[], nn.Module]:
    """The next child of a built ``Compact`` module at each call, in the
    order its forward asks for them."""
    names = iter(m._order)
    return lambda: getattr(m, next(names))


def _onto_smallest(step: ShardedStep, groups: Sequence[Shards], front: bool = False
                   ) -> List[Shards]:
    """Each shard list of ``groups`` relaid onto the bounds of the first with
    the fewest planes along the sharded axis, cropped there as
    ``center_crop_to`` crops it (from the front with ``front``, as
    ``_crop_front``)."""
    ax, dim = step.layout.axis, step.layout.dim
    extents = [bounds_of(g, dim)[-1][1] for g in groups]
    n = min(extents)
    ref = bounds_of(groups[extents.index(n)], dim)
    return [relayout(g, ax, [(a + off, b + off) for a, b in ref])
            for g, e in zip(groups, extents) for off in [0 if front else (e - n) // 2]]


def _cat(step: ShardedStep, groups: Sequence[Shards]) -> Shards:
    """``concat_crop`` of each shard's tensors: its crop along the sharded
    axis a relayout onto the first smallest tensor's bounds, the plain net's
    centre crop along the others."""
    return [concat_crop(ts) for ts in zip(*_onto_smallest(step, groups))]


def _pooled(step: ShardedStep, xs: Shards, factor: int, fn) -> Shards:
    """A pool of ``factor`` at stride ``factor`` (floor sizes): ``fn`` on each
    shard's window of the outputs it owns."""
    dim = step.layout.dim
    n = bounds_of(xs, dim)[-1][1]
    xs, out = windows(xs, step.layout.axis, factor, factor, 0, "zero", n // factor)
    return on_shards(lambda x, i: fn(x), xs, dim, [d - c for c, d in out])


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
        if stride == 1 or down == "stride":
            return step._conv(nxt(), h)
        h = step._conv(nxt(), h)   # a stride-1 conv, then the downsample
        if down in ("lanczos2", "lanczos3"):
            return _lanczos(step, h, stride, int(down[-1]))
        return _pooled(step, h, stride, lambda t: downsample_pool(t, stride, down))

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


def _lanczos(step: ShardedStep, xs: Shards, factor: int, support: int) -> Shards:
    """``lanczos_downsample`` over the shards: its passes in the plain
    order, the one along the sharded axis on each shard's window of the
    outputs it owns over a replicate edge (the plain pass's edge padding by
    ``lanczos_halo`` planes at the volume's ends), unpadded there."""
    dim = step.layout.dim
    lo, hi = lanczos_halo(factor, support)
    for ax in range(2, xs[0].ndim):
        sizes = None
        if ax == dim:
            n = bounds_of(xs, dim)[-1][1]
            xs, out = windows(xs, step.layout.axis, lo + hi + factor, factor, lo, "replicate",
                              n // factor)
            sizes = [d - c for c, d in out]
        xs = on_shards(lambda x, i: lanczos_pass(x, ax, factor, support, padded=ax != dim),
                       xs, dim, sizes)
    return xs


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


def _deconv(step: ShardedStep, m: ConvTranspose, xs: Shards) -> Shards:
    """``ConvTranspose`` (SAME: stride x the input's planes) on the shards,
    in the promoted dtype: each shard with the input planes its outputs
    read past its ends (one on each side for k = 4, stride 2), zeros at
    the volume's ends (where the plain conv has no input), transposed as
    the plain conv, and cropped to its own stride x planes."""
    s, p, k = m.stride, m.padding, m.kernel.shape[2]
    lo, hi = (k - 1 - p) // s, (p + s - 1) // s
    dt = _promoted(xs[0])
    dim = step.layout.dim
    sizes = [s * x.shape[dim] for x in xs]
    xs = halo_exchange([x.to(dt) for x in xs], step.layout.axis, lo, hi, "zero")
    conv_t = (F.conv_transpose1d, F.conv_transpose2d, F.conv_transpose3d)[xs[0].ndim - 3]
    ws = step._rep(m.kernel)
    biases = step._rep(m.bias) if m.bias is not None else [None] * len(xs)

    def deconv(x: torch.Tensor, i: int) -> torch.Tensor:
        b = biases[i]
        y = conv_t(x, ws[i].to(dt), None if b is None else b.to(dt), stride=s, padding=p,
                   output_padding=m.output_padding)
        return y.narrow(dim, s * lo, y.shape[dim] - s * (lo + hi))
    return on_shards(deconv, xs, dim, sizes)


def _unet(step: ShardedStep, m: UNet, xs: Shards) -> Shards:
    """``UNet.forward`` over the shards: the ``concat_x`` input pyramid,
    the ``more_layers`` levels, an upsample-and-conv or deconv up path."""
    nxt = _children(m)
    pyramid = [xs]
    for _ in range(4 + m.more_layers if m.concat_x else 0):
        pyramid.append(_pooled(step, pyramid[-1], 2, lambda t: _pool(t, "avg")))

    def maybe_cat(h: Shards, i: int) -> Shards:
        return _cat(step, [h, pyramid[i]]) if m.concat_x else h

    def up(h: Shards) -> Shards:
        if m.upsample_mode == "deconv":
            return _deconv(step, nxt(), h)
        conv = nxt()
        return step._conv(conv, step._upsample(h, m.upsample_mode))

    h = maybe_cat(_unet_conv(step, nxt(), xs), 0)
    skips = [h]
    for i in range(1, 5):
        h = step._drop(m.drop, _pooled(step, h, 2, lambda t: _pool(t, "max")))
        h = maybe_cat(step._drop(m.drop, _unet_conv(step, nxt(), h)), i)
        skips.append(h)
    for j in range(m.more_layers):
        h = _pooled(step, h, 2, lambda t: _pool(t, "max"))
        h = maybe_cat(_unet_conv(step, nxt(), h), 5 + j)
        skips.append(h)
    h = skips[-1]
    for j in range(m.more_layers):
        u = up(h)   # its child comes before the UNetConv's
        h = _unet_conv(step, nxt(), _cat(step, [u, skips[-(2 + j)]]))
    for i in range(4, 0, -1):
        u = up(h)
        h = step._drop(m.drop, _unet_conv(step, nxt(), _cat(step, [u, skips[i - 1]])))
    return [m.last_act(t) for t in step._conv(nxt(), h)]


# -- the partial-conv U-Net --------------------------------------------------

def _flax_conv(step: ShardedStep, m: FlaxConv, xs: Shards) -> Shards:
    """``FlaxConv`` of stride 1 (the partial conv's) on the shards:
    ``F.conv*`` in the promoted dtype over a zero halo of its padding,
    unpadded along the axis, so its weight gradient is cuDNN's, as in the
    plain net."""
    ax, p, nd = step.layout.axis, m.padding, xs[0].ndim - 2
    dt = _promoted(xs[0])
    sizes = [x.shape[step.layout.dim] for x in xs]
    xs = [x.to(dt) for x in xs]
    if p:
        xs = halo_exchange(xs, ax, p, p, "zero")
    pads = tuple(0 if d == ax else p for d in range(nd))
    conv = (F.conv1d, F.conv2d, F.conv3d)[nd - 1]
    ws = step._rep(m.kernel)
    biases = step._rep(m.bias) if m.bias is not None else [None] * len(xs)
    return on_shards(lambda x, i: conv(x, ws[i].to(dt), None if biases[i] is None
                                       else biases[i].to(dt), stride=1, padding=pads),
                     xs, step.layout.dim, sizes)


def _window_sums(step: ShardedStep, ms: Shards, k: int, p: int) -> Shards:
    """The partial conv's window sum (``partial._window_sum``, stride 1) of
    each shard over a zero halo of ``p`` planes, unpadded along the axis."""
    ax, nd = step.layout.axis, ms[0].ndim - 2
    sizes = [t.shape[step.layout.dim] for t in ms]
    if p:
        ms = halo_exchange(ms, ax, p, p, "zero")
    pads: List[int] = []
    for d in reversed(range(nd)):   # F.pad lists the last dim first
        pads += [0, 0] if d == ax else [p, p]
    pool = (F.avg_pool2d, F.avg_pool3d)[nd - 2]
    return on_shards(lambda t, i: pool(F.pad(t, pads), k, 1, divisor_override=1), ms,
                     step.layout.dim, sizes)


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
    (``_crop_front``): along the sharded axis a relayout onto the smaller
    one's bounds."""
    a, b = _onto_smallest(step, [a, b], front=True)
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


# -- CBAM and the CBAM U-Net -------------------------------------------------

def _dense(step: ShardedStep, m, vs: Shards) -> Shards:
    """flax's ``nn.Dense`` (``blocks.Dense``) on each shard's copy of a
    vector, with that shard's replicated parameters."""
    biases = step._rep(m.bias) if m.bias is not None else [None] * len(vs)
    out = []
    for v, w, b in zip(vs, step._rep(m.kernel), biases):
        dt = _promoted(v)
        out.append(F.linear(v.to(dt), w.to(dt), None if b is None else b.to(dt)))
    return out


def _channel_gate(step: ShardedStep, m: ChannelGate, xs: Shards) -> Shards:
    """``ChannelGate.forward`` over the shards: the whole volume's max
    (``all_max``) and mean (the shards' sums all-reduced in float32, or
    float64 for float64 shards, over the voxel count, in the input's
    dtype), each through the shared MLP on every shard."""
    nxt = _children(m)
    d0, d1 = nxt(), nxt()
    axes = tuple(range(2, xs[0].ndim))
    count = float(sum(x[0, 0].numel() for x in xs))
    maxes = [t.flatten(1) for t in all_max(xs, axes)]
    sums = all_reduce([x.to(torch.promote_types(x.dtype, torch.float32)).sum(dim=axes)
                       for x in xs])
    means = [(t / count).to(x.dtype) for t, x in zip(sums, xs)]

    def mlp(vs: Shards) -> Shards:
        return _dense(step, d1, [F.relu(h) for h in _dense(step, d0, vs)])
    gates = [torch.sigmoid(a + b) for a, b in zip(mlp(maxes), mlp(means))]
    return [x * g.view(g.shape + (1,) * len(axes)) for x, g in zip(xs, gates)]


def _spatial_gate(step: ShardedStep, m: SpatialGate, xs: Shards) -> Shards:
    """``SpatialGate.forward`` over the shards: the channel max and mean are
    local, the 7 x 7 conv takes a zero halo of 3 planes, the Norm the
    volume's statistics."""
    nxt = _children(m)
    pooled = [torch.cat([torch.amax(x, dim=1, keepdim=True), torch.mean(x, dim=1, keepdim=True)],
                        1) for x in xs]
    conv = nxt()
    g = step._norm(nxt(), step._conv(conv, pooled))
    return [x * torch.sigmoid(t) for x, t in zip(xs, g)]


def _cbam(step: ShardedStep, m: CBAM, xs: Shards) -> Shards:
    nxt = _children(m)
    xs = _channel_gate(step, nxt(), xs)
    return _spatial_gate(step, nxt(), xs)


def _attention_unet(step: ShardedStep, m: AttentionUnet, xs: Shards) -> Shards:
    """``AttentionUnet.forward`` over the shards: its 2x max pools on each
    shard's window of its outputs, its bilinear upsamples over the resize's
    replicate halo; with ``att != "cbam"`` the same walk without gates."""
    nxt = _children(m)

    def att(h: Shards) -> Shards:
        return _cbam(step, nxt(), h) if m.att == "cbam" else h

    def block(h: Shards) -> Shards:
        for _ in range(2):
            h = step._cna(nxt(), h)
        return h

    def pool(h: Shards) -> Shards:
        return _pooled(step, h, 2, lambda t: F.max_pool2d(t, 2, 2))

    d1 = att(block(xs))
    d2 = att(block(pool(d1)))
    d3 = att(block(pool(d2)))
    d4 = att(block(pool(d3)))
    up = step._upsample(block(pool(d4)), "bilinear")
    for skip in (d4, d3, d2):
        up = step._upsample(att(block(_cat(step, [skip, up]))), "bilinear")
    h = att(block(_cat(step, [d1, up])))
    return step._conv(nxt(), h)


# -- the ConvGRU ensemble ----------------------------------------------------

def _conv_norm(step: ShardedStep, nxt, xs: Shards) -> Shards:
    conv = nxt()
    return step._norm(nxt(), step._conv(conv, xs))


def _resnet_block(step: ShardedStep, m: ResNetBasicBlock, xs: Shards) -> Shards:
    """``ResNetBasicBlock.forward``: its stride-2 convs (the 1 x 1
    projection among them) on each shard's window of its outputs, its
    Norms over the whole volume."""
    nxt = _children(m)
    h = [F.relu(t) for t in _conv_norm(step, nxt, xs)]
    h = _conv_norm(step, nxt, h)
    if m.stride != 1 or xs[0].shape[1] != m.features:
        xs = _conv_norm(step, nxt, xs)
    return [F.relu(a + b) for a, b in zip(xs, h)]


def _stem_pool(step: ShardedStep, xs: Shards) -> Shards:
    """``F.max_pool2d(h, 3, 2, padding=1)`` on each shard's window of its
    outputs (-inf past the volume's start), unpadded along the axis, padded
    by one along the other."""
    ax, dim = step.layout.axis, step.layout.dim
    xs, out = windows(xs, ax, 3, 2, 1, "-inf")
    pad = tuple(0 if d == ax else 1 for d in range(2))
    return on_shards(lambda x, i: F.max_pool2d(x, 3, 2, padding=pad), xs, dim,
                     [d - c for c, d in out])


def _encoder(step: ShardedStep, m: Encoder, xs: Shards) -> Shards:
    """``Encoder.forward``: the 7 x 7 stride-2 stem over a (3, 2) zero
    halo, the stem pool, the 16 basic blocks."""
    nxt = _children(m)
    h = [F.relu(t) for t in _conv_norm(step, nxt, xs)]
    h = _stem_pool(step, h)
    for _ in range(16):
        h = _resnet_block(step, nxt(), h)
    return h


def _gru(step: ShardedStep, m: ConvGRUCell, xs: Shards, state: Shards) -> Shards:
    """``ConvGRUCell.forward``: its three flax convs over a zero halo."""
    nxt = _children(m)
    stacked = [torch.cat([x, s], 1) for x, s in zip(xs, state)]
    update = [torch.sigmoid(t) for t in _flax_conv(step, nxt(), stacked)]
    reset = [torch.sigmoid(t) for t in _flax_conv(step, nxt(), stacked)]
    out = [torch.tanh(t) for t in _flax_conv(step, nxt(), [
        torch.cat([x, s * r], 1) for x, s, r in zip(xs, state, reset)])]
    return [s * (1 - u) + o * u for s, u, o in zip(state, update, out)]


def _decoder(step: ShardedStep, m: Decoder, xs: Shards) -> Shards:
    nxt = _children(m)
    for _ in range(5):
        xs = step._upsample(step._cna(nxt(), xs), m.upsample_mode)
    xs = step._cna(nxt(), xs)
    return step._conv(nxt(), xs)


def _ensemble(step: ShardedStep, m: Ensemble, xs: Shards) -> Shards:
    """``Ensemble.forward`` over the shards: the encoder once, then the
    shared step (GRU update, decode) a frame, the frames stacked on the
    batch dim."""
    nxt = _children(m)
    feature = _encoder(step, nxt(), xs)
    state = [torch.zeros((f.shape[0], m.hidden) + f.shape[2:], dtype=f.dtype, device=f.device)
             for f in feature]
    rollout, outs = nxt(), []
    for _ in range(m.num_frames):
        parts = _children(rollout)
        state = _gru(step, parts(), feature, state)
        outs.append(_decoder(step, parts(), state))
    return [torch.cat(frames, 0) for frames in zip(*outs)]


# the walk of each class a sharded solve covers (the MulResUnet's is
# ``ShardedStep``'s own); a library block given to the solver alone is
# walked as the nets walk it. The blocks whose output never has the input's
# planes (the encoder, the decoder, a transposed conv) or that take two
# inputs are refused before (``engine.solver.check_net_output``)
_WALKS = {
    SkipNet: _skip, UNet: _unet, PartialUNet: _partial, AttMulResUnet: _attention,
    AttentionUnet: _attention_unet, Ensemble: _ensemble,
    CBAM: _cbam, ChannelGate: _channel_gate, SpatialGate: _spatial_gate,
    Conv: lambda step, m, xs: step._conv(m, xs),
    ConvNormAct: lambda step, m, xs: step._cna(m, xs),
    Norm: lambda step, m, xs: step._norm(m, xs),
    FlaxConv: _flax_conv,
    MultiResBlock: lambda step, m, xs: step._multires(m, xs),
    ResPath: lambda step, m, xs: step._respath(m, xs),
    UNetConv: _unet_conv, ResNetBasicBlock: _resnet_block,
}
