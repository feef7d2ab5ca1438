"""A module of the caller's own over spatial shards (ROADMAP A.13c item 13).

The JAX package shards any flax module: its sharding is data placement,
and GSPMD partitions whatever the step computes. Here the caller's
``forward`` runs once a step on a ``ShardList``, a tensor subclass whose
value is a meta tensor of the whole logical shape (so ``x.shape``,
``x.dim()`` and ``x.dtype`` read as in the unsharded module) and which
holds the list of shards, the sharded dim and a pending edge pad. Every op
the forward applies to it reaches ``ShardList.__torch_function__`` and is
mapped onto a stated vocabulary, whose sharded form of each op launches
what its unsharded form launches:

  * a library net or block that a sharded walk covers
    (``spatial_zoo.covered_class``, a subclass that keeps its base's
    ``forward`` among them) takes that walk: for the call, the ``forward``
    of each outermost such child is bound to ``ShardedStep.walk`` of a
    child step, so its parameters, halos, dropout draws and kernel launches
    are those of today's walks;
  * local ops: elementwise ops and activations, casts, ``where``,
    ``clamp``, ``cat``/``stack`` (two shard lists of one extent along the
    sharded dim but other bounds: the second relaid onto the first's,
    ``spatial.relayout``), slicing and splits along the other dims,
    reductions, ``softmax`` and ``F.linear`` over them, reshapes that keep
    the sharded dim whole and its own, permutations, ``F.pad`` along the
    other dims, nearest ``F.interpolate`` by an integer, pools whose kernel
    is their stride;
  * window ops (``spatial.windows``: each shard owns the output planes
    whose first input plane it holds and reads their window, a halo or a
    crop): ``F.conv*`` with zero padding (an int, a tuple or ``'same'``)
    whose output along the axis is its input over the stride (rounded up
    or down), run unpadded along the axis through cuDNN's autograd, as the
    unsharded module runs it; ``F.pad`` reflect, replicate or zero along
    the axis, kept pending on the list and taken by the next unpadded conv
    or pool as that edge's padding; pools (-inf padding for the max, zeros
    for the avg); linear ``F.interpolate`` by an integer (the resize's
    replicate halo: one plane, two for bicubic, the output planes they
    alone decide cropped); ``F.conv_transpose*`` whose output is its input
    times the stride (``_deconv``'s halo);
  * spatial reductions: ``sum``/``mean`` over dims that hold the sharded
    one all-reduce the shards' float32 (float64) partial sums in shard
    order, ``amax``/``amin``/``max``/``min`` take ``all_max``, ``var``,
    ``std`` and the batch (batch statistics), instance, group and layer
    norms the two-pass form (the mean, then the squared deviations from
    it), an adaptive pool to one plane along the axis the mean or the max.
    The result is a *replicated* list, one copy a shard; ops between
    replicated values are plain, and a replicated value broadcasts against
    shards;
  * the port's own ops (``conv_same``, ``blocks.upsample``,
    ``linear_upsample2x``, ``space_to_depth``, ``depth_to_space``,
    ``upsample_into_phase``, ``lanczos_downsample``) hand a
    ``__torch_function__`` tensor here at their entry, before their
    autograd Function, whose ``apply`` would run its forward on the list
    with the gradient lost: they take ``ShardedStep``'s pieces
    (``conv_halo`` and the wgrad kernel, ``_upsample`` and the upsample
    kernel);
  * a parameter or buffer takes its replicated copy (``ShardedStep._rep``);
    any other plain tensor is moved to each shard's device, or split as
    the shards lie where it spans the sharded dim: a mask drawn whole at the
    volume's shape, as ``blocks.Dropout`` draws, and ``F.dropout*``'s masks
    drawn whole on the first shard's device, so both are the unsharded
    module's draws bit for bit.

Anything else raises ``NotImplementedError`` naming the op and ROADMAP
A.13c item 13: slicing, ``flip``, ``roll`` or an FFT along the sharded dim,
``.item()`` or ``bool()`` of a shard list, an op under ``torch.no_grad()``
or inside a custom ``autograd.Function`` in a forward that needs
gradients, a pending pad used otherwise. ``meta_pass`` runs the forward
once over meta shards before anything is drawn: it meets every refusal and
finds the shard block, the largest product of the strides met along the
axis on any path (a dispatched child's own block scaled by the factor at
its call): the shards lie on it where the axis holds at least one block a
shard, so every stride halves every shard, and elsewhere they need not. A
shard that holds no planes (at a deep level of a fine split) launches
nothing.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import math
from fractions import Fraction
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..models import blocks
from ..models.blocks import Compact, Conv, FlaxConv
from ..models.convgru import ResNetBasicBlock
from ..models.mulresunet import MulResUnet
from ..ops import phase_space as ps
from ..ops.conv_vjp import _pairs, conv_halo, conv_same
from ..ops.upsample import linear_upsample2x
from . import spatial_zoo
from .spatial import (ShardedStep, all_max, all_reduce, bounds_of, halo_exchange, on_shards,
                      relayout, rounded, shard_bounds, windows)

__all__ = ["ShardList", "meta_pass", "run"]

ITEM = "ROADMAP A.13c item 13"
META = torch.device("meta")
Shards = List[torch.Tensor]


def _refuse(what: str):
    raise NotImplementedError(f"{what} on spatial shards is outside the sharded walker's "
                              f"vocabulary: {ITEM}")


class _Walk:
    """One run of a caller's forward over the shards: its step, whether it
    needs gradients, and the shard block its strides prefer."""

    def __init__(self, step: ShardedStep):
        self.step = step
        self.mesh = step.layout.mesh
        self.grad = torch.is_grad_enabled()
        self.block = 1

    def need(self, x: "ShardList", stride: int) -> None:
        """Record that a shard of ``x`` halves exactly under ``stride`` where
        it holds whole blocks of ``stride * scale`` planes of the volume
        (``stride`` planes of ``x``): the preferred shard block."""
        self.block = math.lcm(self.block, (Fraction(stride) * x._scale).numerator)

    def place(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """A plain tensor on shard ``i``'s device: a parameter's or buffer's
        replicated copy, or the tensor moved there."""
        reps = self.step._reps.get(id(t))
        if reps is not None:
            return reps[i]
        d = self.mesh[i]
        return t if t.device == d else t.to(d)


class ShardList(torch.Tensor):
    """A tensor of a caller's forward over spatial shards: its value a meta
    tensor of the whole logical shape; ``_parts`` the shards (or one copy a
    shard of a replicated value, ``_sdim`` None), ``_sdim`` the sharded
    dim, ``_scale`` how many planes of the volume one plane along it spans,
    ``_pad`` a pending edge pad ``(lo, hi, edge)`` along it."""

    _walk: _Walk
    _parts: Shards
    _sdim: Optional[int]
    _scale: Optional[Fraction]
    _pad: Optional[Tuple[int, int, str]]
    _logical: torch.Tensor

    def _extents(self) -> List[int]:
        return [p.shape[self._sdim] for p in self._parts]

    def _offsets(self) -> List[int]:
        return [0] + list(itertools.accumulate(self._extents()))

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        lists = [a for a in _leaves((args, kwargs)) if isinstance(a, ShardList)]
        x = lists[0]
        if getattr(func, "__name__", None) == "__get__":
            return _attribute(func, x)
        if func in _READS:
            return func(*_logicals(args), **_logicals(kwargs))
        name = _name(func)
        if x._walk.grad and not torch.is_grad_enabled():
            _refuse(f"{name} under torch.no_grad() or inside a custom autograd.Function")
        handler = _HANDLERS.get(func)
        if handler is None:
            _refuse(name)
        if any(a._pad is not None for a in lists) and handler not in _TAKE_PAD:
            _refuse(f"{name} of a pending pad along the sharded dim (only an unpadded conv "
                    f"or pool takes it)")
        if "out" in kwargs:
            _refuse(f"{name}(out=...)")
        return handler(x._walk, func, args, kwargs)

    def __repr__(self, *args, **kwargs) -> str:
        where = "replicated" if self._sdim is None else f"sharded along dim {self._sdim}"
        return (f"ShardList({tuple(self._logical.shape)}, {self._logical.dtype}, "
                f"{len(self._parts)} parts, {where})")


def _wrap(walk: _Walk, parts: Shards, sdim: Optional[int], scale: Optional[Fraction],
          logical: torch.Tensor, pad: Optional[Tuple[int, int, str]] = None) -> ShardList:
    """``parts`` as a shard list of ``logical``'s shape and dtype."""
    want = list(logical.shape)
    for p in parts:
        got = list(p.shape)
        if sdim is not None:
            got[sdim] = want[sdim]
        if got != want or p.dtype != logical.dtype:
            raise RuntimeError(f"a part {tuple(p.shape)} {p.dtype} of a shard list of "
                               f"{tuple(want)} {logical.dtype} (sharded dim {sdim})")
    if sdim is not None and pad is None and sum(p.shape[sdim] for p in parts) != want[sdim]:
        raise RuntimeError(f"shards of {[p.shape[sdim] for p in parts]} planes make a dim "
                           f"of {want[sdim]}")
    t = logical.detach().as_subclass(ShardList)
    t._walk, t._parts, t._sdim, t._scale, t._pad = walk, list(parts), sdim, scale, pad
    t._logical = logical.detach()
    return t


def _whole(walk: _Walk, parts: Shards, dim: int) -> ShardList:
    shape = list(parts[0].shape)
    shape[dim] = sum(p.shape[dim] for p in parts)
    return _wrap(walk, parts, dim, Fraction(1),
                 torch.empty(shape, dtype=parts[0].dtype, device=META))


def _leaves(obj):
    if isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _leaves(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _leaves(o)
    else:
        yield obj


def _meta(t: torch.Tensor) -> torch.Tensor:
    if isinstance(t, ShardList):
        return t._logical
    return t if t.is_meta else torch.empty_like(t, device=META)


def _logicals(obj):
    """``obj`` with each tensor as a meta tensor of its (logical) shape."""
    if isinstance(obj, torch.Tensor):
        return _meta(obj)
    if isinstance(obj, (list, tuple)) and not isinstance(obj, torch.Size):
        return type(obj)(_logicals(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _logicals(v) for k, v in obj.items()}
    return obj


def _map(obj, i: int, walk: _Walk, split: Dict[int, Tuple[int, List[int]]]):
    """``obj`` for shard ``i``: a shard list's part, a plain tensor placed
    on its device, or its slice where ``split`` says it spans the sharded
    dim (dim, offsets)."""
    if isinstance(obj, ShardList):
        return obj._parts[i]
    if isinstance(obj, torch.Tensor):
        s = split.get(id(obj))
        if s is not None:
            dim, offs = s
            return walk.place(obj.narrow(dim, offs[i], offs[i + 1] - offs[i]), i)
        return walk.place(obj, i)
    if isinstance(obj, (list, tuple)) and not isinstance(obj, torch.Size):
        return type(obj)(_map(o, i, walk, split) for o in obj)
    if isinstance(obj, dict):
        return {k: _map(v, i, walk, split) for k, v in obj.items()}
    return obj


def _per_part(walk: _Walk, func, args, kwargs, split=None) -> list:
    split = split or {}
    return [func(*_map(args, i, walk, split), **_map(kwargs, i, walk, split))
            for i in range(len(walk.mesh))]


def _out(walk: _Walk, results: list, logical, sdim: Optional[int], scale) -> Any:
    """Per-part results as shard lists of ``logical`` (a tuple of them
    where the op returns several tensors)."""
    if isinstance(logical, torch.Tensor):
        return _wrap(walk, results, sdim, scale, logical)
    return tuple(_wrap(walk, [r[k] for r in results], sdim, scale, t)
                 for k, t in enumerate(logical))


def _name(func) -> str:
    n = getattr(func, "__name__", None) or repr(func)
    q = getattr(func, "__qualname__", "") or ""
    mod = getattr(func, "__module__", "") or ""
    if q.startswith(("TensorBase.", "Tensor.")):
        return f"Tensor.{n}"
    if mod.startswith("torch.nn.functional") or mod == "torch._C._nn":
        return f"F.{n}"
    if mod.startswith("deep_prior_interpolation_tpu_torch"):
        return n
    return f"torch.{n}"


def _bind(args, kwargs, names: Sequence[str], defaults: Dict[str, Any]) -> Dict[str, Any]:
    a = dict(defaults)
    a.update(zip(names, args))
    a.update(kwargs)
    return a


def _dim(d: int, nd: int) -> int:
    return d + nd if d < 0 else d


def _dims(dim, nd: int) -> List[int]:
    """A reduction's dims, normalised; None or empty: every dim."""
    if dim is None or (isinstance(dim, (list, tuple)) and len(dim) == 0):
        return list(range(nd))
    if isinstance(dim, int):
        return [_dim(dim, nd)]
    return sorted(_dim(d, nd) for d in dim)


def _tuple(v, n: int) -> Tuple[int, ...]:
    if isinstance(v, (list, tuple)):
        return tuple(v) if len(v) == n else tuple(v) * n
    return (v,) * n


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The dtype the shards' partial sums take: float32, float64 for a
    float64 (or integer) input."""
    if not dtype.is_floating_point:
        return torch.float64
    return torch.promote_types(dtype, torch.float32)


def _windowed(walk: _Walk, x: ShardList, k: int, s: int, pad: Tuple[int, int], edge: str,
              out_ext: int, name: str) -> Tuple[Shards, int, int, str, List[int]]:
    """Each shard's window of the outputs it owns (``spatial.windows``) of a
    window of ``k`` planes at stride ``s``: its padding (``pad``, whose
    planes follow ``edge``) or a pending pad's (and its edge) before and
    after the volume. The op's output along the axis must be its input's
    over the stride, rounded up or down. Returns the windows, ``lo``,
    ``hi``, the edge and each shard's output planes."""
    ext, (lo, hi) = x._logical.shape[x._sdim], pad
    if x._pad is not None:
        if tuple(pad) != (0, 0):
            _refuse(f"{name} with padding of its own along the sharded dim after a pending "
                    f"pad")
        lo, hi, edge = x._pad
        ext -= lo + hi
    if out_ext not in (ext // s, -(-ext // s)):
        _refuse(f"{name} whose output along the sharded dim ({out_ext} planes) is not its "
                f"input's {ext} over the stride {s}")
    walk.need(x, s)
    xs, out = windows(x._parts, x._sdim - 2, k, s, lo, edge, out_ext)
    return xs, lo, hi, edge, [d - c for c, d in out]


# -- the vocabulary ------------------------------------------------------------

def _attribute(func, x: ShardList):
    """A property read: the logical tensor's, the device that of the first
    shard, ``requires_grad`` any shard's."""
    desc = func.__self__
    if desc in _LOGICAL_ATTRS:
        return func(x._logical)
    if desc in _PART_ATTRS:
        return func(x._parts[0])
    if desc is torch._C.TensorBase.requires_grad:
        return any(p.requires_grad for p in x._parts)
    _refuse(f"Tensor.{getattr(desc, '__name__', desc)}")


def _elementwise(walk: _Walk, func, args, kwargs):
    """An elementwise op (broadcasting): each shard with its own slice of
    any operand that spans the sharded dim, a replicated copy of the rest."""
    name = _name(func)
    if name.endswith("_") and not isinstance(args[0], ShardList):
        _refuse(f"{name} into a plain tensor")
    logical = func(*_logicals(args), **_logicals(kwargs))
    if not isinstance(logical, torch.Tensor):
        _refuse(name)
    args, kwargs = _onto_first(walk, name, (args, kwargs))
    leaves = [t for t in _leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
    sd, split, scale = _aligned(name, leaves, logical)
    return _out(walk, _per_part(walk, func, args, kwargs, split), logical, sd, scale)


def _onto_first(walk: _Walk, name: str, obj):
    """``obj`` (an op's arguments) with each shard list sharded as the
    first one but on other bounds relaid onto the first's bounds."""
    sharded = [t for t in _leaves(obj) if isinstance(t, ShardList) and t._sdim is not None]
    if not sharded:
        return obj
    ref = sharded[0]
    bounds = bounds_of(ref._parts, ref._sdim)
    moved = {}
    for t in sharded[1:]:
        if t._pad is not None or bounds_of(t._parts, t._sdim) == bounds:
            continue
        if t._logical.ndim - t._sdim != ref._logical.ndim - ref._sdim \
                or bounds_of(t._parts, t._sdim)[-1][1] != bounds[-1][1]:
            _refuse(f"{name} of shard lists that span the sharded dim otherwise")
        moved[id(t)] = _wrap(walk, relayout(t._parts, t._sdim - 2, bounds), t._sdim, t._scale,
                             t._logical)

    def sub(o):
        if isinstance(o, torch.Tensor):
            return moved.get(id(o), o)
        if isinstance(o, (list, tuple)) and not isinstance(o, torch.Size):
            return type(o)(sub(v) for v in o)
        if isinstance(o, dict):
            return {k: sub(v) for k, v in o.items()}
        return o
    return sub(obj) if moved else obj


def _aligned(name: str, leaves: Sequence[torch.Tensor], out: torch.Tensor):
    """The output's sharded dim (None: replicated), the plain operands to
    split as the shards lie, and the scale, for operands broadcast to
    ``out``."""
    nd = out.ndim
    sharded = [t for t in leaves if isinstance(t, ShardList) and t._sdim is not None]
    if not sharded:
        return None, {}, None
    dims = {t._sdim + nd - t._logical.ndim for t in sharded}
    if len(dims) != 1:
        _refuse(f"{name} of shard lists sharded along different dims")
    sd, src = dims.pop(), sharded[0]
    split = {}
    for t in leaves:
        if isinstance(t, ShardList) and t._sdim is not None:
            continue
        shape = _meta(t).shape
        j = sd - (nd - len(shape))
        if j < 0 or shape[j] == 1:
            continue
        if isinstance(t, ShardList) or shape[j] != out.shape[sd]:
            _refuse(f"{name} of a tensor that spans the sharded dim otherwise than its shards")
        split[id(t)] = (j, src._offsets())
    return sd, split, src._scale


def _same(walk: _Walk, func, args, kwargs):
    """An op that keeps its input's layout (a copy, a cast of its own)."""
    x = args[0]
    logical = func(*_logicals(args), **_logicals(kwargs))
    return _out(walk, _per_part(walk, func, args, kwargs), logical, x._sdim, x._scale)


def _along(pos: Optional[int], key: Optional[str], default=None):
    """An op along one dim (``softmax``, ``cumsum``, ``F.normalize``;
    ``F.linear`` on the last dim, ``F.prelu`` on the channels, which take
    no ``pos``): local where that dim is not the sharded one."""
    def handler(walk: _Walk, func, args, kwargs):
        x = args[0]
        d = default
        if pos is not None:
            d = args[pos] if len(args) > pos else kwargs.get(key, default)
        logical = func(*_logicals(args), **_logicals(kwargs))
        if x._sdim is not None and (d is None or _dim(d, x._logical.ndim) == x._sdim):
            _refuse(f"{_name(func)} along the sharded dim")
        return _out(walk, _per_part(walk, func, args, kwargs), logical, x._sdim, x._scale)
    return handler


def _cast(walk: _Walk, func, args, kwargs):
    """``to``/``type``/``type_as`` and the dtype methods: a cast of each
    part; a move to another device is refused."""
    x, name = args[0], _name(func)
    fixed = {"Tensor.float": torch.float32, "Tensor.double": torch.float64,
             "Tensor.half": torch.float16, "Tensor.bfloat16": torch.bfloat16}
    dtype = fixed.get(name)
    if dtype is None:
        for a in list(args[1:]) + list(kwargs.values()):
            if isinstance(a, torch.dtype):
                dtype = a
            elif isinstance(a, torch.Tensor):
                dtype = _meta(a).dtype
            elif isinstance(a, (str, torch.device)):
                _refuse(f"{name} to a device")
    if dtype is None:
        return x
    logical = x._logical.to(dtype)
    return _wrap(walk, [p.to(dtype) for p in x._parts], x._sdim, x._scale, logical)


def _new(walk: _Walk, func, args, kwargs):
    """``new_zeros`` and the like: a plain tensor on the first shard's
    device."""
    return func(args[0]._parts[0], *args[1:], **kwargs)


def _reshape(walk: _Walk, func, args, kwargs):
    """A reshape (``view``, ``reshape``, ``flatten``, ``unflatten``,
    ``squeeze``, ``unsqueeze``, ``view_as``) that keeps the sharded dim
    whole and its own: some output dim has its extent and the same product
    of extents before it."""
    x, name = args[0], _name(func)
    if name == "Tensor.view" and len(args) == 2 and isinstance(args[1], torch.dtype):
        if args[1].itemsize != x._logical.dtype.itemsize:
            _refuse(f"{name} as a dtype of another size")
        return _same(walk, func, args, kwargs)
    logical = func(*_logicals(args), **_logicals(kwargs))
    if x._sdim is None:
        return _out(walk, _per_part(walk, func, args, kwargs), logical, None, None)
    src, dst, d = list(x._logical.shape), list(logical.shape), x._sdim
    before = math.prod(src[:d])
    out = next((k for k in range(len(dst))
                if dst[k] == src[d] and math.prod(dst[:k]) == before), None)
    if out is None:
        _refuse(f"{name} that merges or splits the sharded dim")
    parts = []
    for p in x._parts:
        shape = list(dst)
        shape[out] = p.shape[d]
        parts.append(p.reshape(shape))
    return _wrap(walk, parts, out, x._scale, logical)


_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def _permute(walk: _Walk, func, args, kwargs):
    """A permutation of the dims (``permute``, ``transpose``, ``movedim``):
    where the sharded dim lands, from the op on a meta tensor of distinct
    extents."""
    x = args[0]
    logical = func(*_logicals(args), **_logicals(kwargs))
    sd = None
    if x._sdim is not None:
        probe = torch.empty(_PRIMES[:x._logical.ndim], device=META)
        sd = list(func(probe, *args[1:], **kwargs).shape).index(_PRIMES[x._sdim])
    return _out(walk, _per_part(walk, func, args, kwargs), logical, sd, x._scale)


def _expand(walk: _Walk, func, args, kwargs):
    """``expand``: the sharded dim keeps each shard's extent."""
    x = args[0]
    logical = func(*_logicals(args), **_logicals(kwargs))
    if x._sdim is None:
        return _out(walk, _per_part(walk, func, args, kwargs), logical, None, None)
    sizes = list(args[1]) if len(args) == 2 and isinstance(args[1], (list, tuple)) \
        else list(args[1:] or kwargs.get("size"))
    sd = x._sdim + logical.ndim - x._logical.ndim
    sizes[sd] = -1
    return _wrap(walk, [p.expand(sizes) for p in x._parts], sd, x._scale, logical)


def _split(pos: int, default: int = 0, drops: bool = False):
    """An op that splits or picks along a dim (``split``, ``chunk``,
    ``narrow``, ``select``, ``unbind``): local along any dim but the
    sharded one."""
    def handler(walk: _Walk, func, args, kwargs):
        x = args[0]
        d = args[pos] if len(args) > pos else kwargs.get("dim", default)
        logical = func(*_logicals(args), **_logicals(kwargs))
        sd = x._sdim
        if sd is not None:
            d = _dim(d, x._logical.ndim)
            if d == sd:
                _refuse(f"{_name(func)} along the sharded dim")
            if drops and d < sd:
                sd -= 1
        return _out(walk, _per_part(walk, func, args, kwargs), logical, sd, x._scale)
    return handler


def _flip(walk: _Walk, func, args, kwargs):
    """``flip``/``roll``: local along dims other than the sharded one (a
    roll without dims rolls the flattened tensor)."""
    x, name = args[0], _name(func)
    pos = 2 if name.endswith("roll") else 1
    d = args[pos] if len(args) > pos else kwargs.get("dims")
    if x._sdim is not None and (d is None or x._sdim in _dims(d, x._logical.ndim)):
        _refuse(f"{name} along the sharded dim")
    return _same(walk, func, args, kwargs)


def _getitem(walk: _Walk, func, args, kwargs):
    """Indexing by ints, slices, None and Ellipsis; along the sharded dim
    only the whole slice."""
    x, idx = args
    name = "Tensor.__getitem__"
    items = idx if isinstance(idx, tuple) else (idx,)
    if any(isinstance(i, (torch.Tensor, list, bool)) for i in items):
        _refuse(f"{name} with a tensor, list or bool index")
    logical = func(x._logical, idx)
    if x._sdim is None:
        return _wrap(walk, [p[idx] for p in x._parts], None, None, logical)
    nd = x._logical.ndim
    used = sum(1 for i in items if i is not None and i is not Ellipsis)
    full = []
    for i in items:
        full += [slice(None)] * (nd - used) if i is Ellipsis else [i]
    sd, d_in, d_out = None, 0, 0
    for i in full:
        if i is None:
            d_out += 1
            continue
        if d_in == x._sdim:
            ext = x._logical.shape[d_in]
            if isinstance(i, int) or i.indices(ext) != (0, ext, 1):
                _refuse(f"{name} along the sharded dim (only the whole slice ':')")
            sd = d_out
        d_out += isinstance(i, slice)
        d_in += 1
    if sd is None:
        sd = d_out + x._sdim - d_in
    return _wrap(walk, [p[idx] for p in x._parts], sd, x._scale, logical)


def _cat(walk: _Walk, func, args, kwargs):
    """``cat``/``stack`` along any dim but the sharded one."""
    name = _name(func)
    args, kwargs = _onto_first(walk, name, (args, kwargs))
    tensors = args[0] if args else kwargs["tensors"]
    d = args[1] if len(args) > 1 else kwargs.get("dim", kwargs.get("axis", 0))
    logical = func(*_logicals(args), **_logicals(kwargs))
    sharded = [t for t in tensors if isinstance(t, ShardList) and t._sdim is not None]
    if not sharded:
        return _out(walk, _per_part(walk, func, args, kwargs), logical, None, None)
    sds = {t._sdim for t in sharded}
    if len(sds) != 1:
        _refuse(f"{name} of shard lists sharded along different dims")
    sd, src = sds.pop(), sharded[0]
    stack = "stack" in name
    d = _dim(d, src._logical.ndim + stack)
    if not stack and d == sd:
        _refuse(f"{name} along the sharded dim")
    split = {}
    for t in tensors:
        if isinstance(t, ShardList) and t._sdim is not None:
            continue
        if isinstance(t, ShardList) or _meta(t).shape[sd] != src._logical.shape[sd]:
            _refuse(f"{name} of a tensor that spans the sharded dim otherwise than its shards")
        split[id(t)] = (sd, src._offsets())
    out_sd = sd + (stack and d <= sd)
    return _wrap(walk, _per_part(walk, func, args, kwargs, split), out_sd, src._scale, logical)


def _repeat_interleave(walk: _Walk, func, args, kwargs):
    """``repeat_interleave`` by an int along one dim (the sharded one too:
    a nearest upsample)."""
    a = _bind(args, kwargs, ("input", "repeats", "dim"), {"dim": None})
    x = a["input"]
    if not isinstance(a["repeats"], int) or a["dim"] is None:
        _refuse(f"{_name(func)} of a tensor repeat or over the flattened tensor")
    logical = func(*_logicals(args), **_logicals(kwargs))
    scale = x._scale
    if x._sdim is not None and _dim(a["dim"], x._logical.ndim) == x._sdim:
        scale = scale / a["repeats"]
    return _out(walk, _per_part(walk, func, args, kwargs), logical, x._sdim, scale)


# -- spatial reductions ----------------------------------------------------------

def _replicated(walk: _Walk, parts: Shards, logical: torch.Tensor) -> ShardList:
    return _wrap(walk, [p.to(logical.dtype).reshape(logical.shape) for p in parts],
                 None, None, logical)


def _sums(parts: Shards, dims: List[int]) -> Shards:
    """The whole volume's sum over ``dims`` (kept), one copy a shard: the
    shards' partial sums in float32 (float64 for float64 shards)
    all-reduced in shard order."""
    f = _acc(parts[0].dtype)
    return all_reduce([p.to(f).sum(dim=dims, keepdim=True) for p in parts])


def _moments(parts: Shards, dims: List[int]):
    """The two-pass moments over ``dims`` (kept), one copy a shard: the
    inputs in the sums' dtype, the mean, the sum of squared deviations from
    it, and the count."""
    f = _acc(parts[0].dtype)
    count = float(sum(math.prod(p.shape[d] for d in dims) for p in parts))
    xf = [p.to(f) for p in parts]
    means = [s / count for s in all_reduce([t.sum(dim=dims, keepdim=True) for t in xf])]
    sqs = all_reduce([((t - m) ** 2).sum(dim=dims, keepdim=True) for t, m in zip(xf, means)])
    return xf, means, sqs, count


def _sum_mean(walk: _Walk, func, args, kwargs):
    """``sum``/``mean``: local over other dims; over the sharded one the
    all-reduced float32 sums (over the count for the mean)."""
    x = args[0]
    a = _bind(args, kwargs, ("input", "dim", "keepdim"), {"dim": None, "keepdim": False})
    logical = func(*_logicals(args), **_logicals(kwargs))
    if x._sdim is None:
        return _out(walk, _per_part(walk, func, args, kwargs), logical, None, None)
    dims = _dims(a["dim"], x._logical.ndim)
    if x._sdim not in dims:
        sd = x._sdim if a["keepdim"] else x._sdim - sum(d < x._sdim for d in dims)
        return _out(walk, _per_part(walk, func, args, kwargs), logical, sd, x._scale)
    tot = _sums(x._parts, dims)
    if _name(func).endswith("mean"):
        count = math.prod(x._logical.shape[d] for d in dims)
        tot = [t / count for t in tot]
    return _replicated(walk, tot, logical)


def _extreme(walk: _Walk, func, args, kwargs):
    """``amax``/``amin``, and ``max``/``min`` of the whole tensor or over a
    dim (values and indices, not along the sharded dim); ``max(x, y)`` is
    elementwise. Over the sharded dim the whole volume's extreme
    (``all_max``)."""
    x, name = args[0], _name(func)
    low = name.endswith("min")
    arg = args[1] if len(args) > 1 else kwargs.get("dim", kwargs.get("other"))
    if isinstance(arg, torch.Tensor):
        return _elementwise(walk, func, args, kwargs)
    logical = func(*_logicals(args), **_logicals(kwargs))
    nd = x._logical.ndim
    if not name.endswith(("amax", "amin")) and arg is not None:   # values and indices
        if x._sdim is not None and _dim(arg, nd) == x._sdim:
            _refuse(f"{name} over the sharded dim (its indices)")
        keep = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
        sd = x._sdim
        if sd is not None and not keep and _dim(arg, nd) < sd:
            sd -= 1
        return _out(walk, _per_part(walk, func, args, kwargs), tuple(logical), sd, x._scale)
    if x._sdim is None:
        return _out(walk, _per_part(walk, func, args, kwargs), logical, None, None)
    dims = _dims(arg, nd)
    if x._sdim not in dims:
        keep = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
        sd = x._sdim if keep else x._sdim - sum(d < x._sdim for d in dims)
        return _out(walk, _per_part(walk, func, args, kwargs), logical, sd, x._scale)
    if not low:
        return _replicated(walk, all_max(x._parts, dims), logical)
    return _replicated(walk, [-t for t in all_max([-p for p in x._parts], dims)], logical)


def _var_std(walk: _Walk, func, args, kwargs):
    """``var``/``std``: over the sharded dim the two-pass form with the
    all-reduced float32 sums, ``correction`` (or ``unbiased``) as given."""
    x = args[0]
    logical = func(*_logicals(args), **_logicals(kwargs))
    rest = list(args[1:])
    dim = kwargs.get("dim")
    unbiased = kwargs.get("unbiased")
    if rest and not isinstance(rest[0], bool):
        dim = rest.pop(0)
    if rest and isinstance(rest[0], bool):
        unbiased = rest.pop(0)
    keep = rest[0] if rest else kwargs.get("keepdim", False)
    correction = kwargs.get("correction", 0 if unbiased is False else 1)
    if x._sdim is None:
        return _out(walk, _per_part(walk, func, args, kwargs), logical, None, None)
    dims = _dims(dim, x._logical.ndim)
    if x._sdim not in dims:
        sd = x._sdim if keep else x._sdim - sum(d < x._sdim for d in dims)
        return _out(walk, _per_part(walk, func, args, kwargs), logical, sd, x._scale)
    _, _, sqs, count = _moments(x._parts, dims)
    var = [q / max(count - correction, 0.0) for q in sqs]
    if _name(func).endswith("std"):
        var = [torch.sqrt(v) for v in var]
    return _replicated(walk, var, logical)


def _affine(y: torch.Tensor, w, b, i: int, walk: _Walk) -> torch.Tensor:
    """``y * w + b`` with per-channel (dim 1) ``w`` and ``b``, either None."""
    shape = (1, -1) + (1,) * (y.ndim - 2)
    if w is not None:
        y = y * walk.place(w, i).to(y.dtype).view(shape)
    if b is not None:
        y = y + walk.place(b, i).to(y.dtype).view(shape)
    return y


def _normalised(walk: _Walk, x: ShardList, dims: List[int], eps: float, w, b,
                logical: torch.Tensor, shaped=None):
    """``x`` normalised over ``dims`` by the whole volume's two-pass
    statistics (``shaped`` views each part for them), then the per-channel
    affine, in the input's dtype; and the statistics (the means, the sums
    of squared deviations, the count)."""
    parts = x._parts if shaped is None else [shaped(p) for p in x._parts]
    xf, means, sqs, count = _moments(parts, dims)
    outs = []
    for i, (p, t, m, q) in enumerate(zip(x._parts, xf, means, sqs)):
        y = ((t - m) * torch.rsqrt(q / count + eps)).reshape(p.shape)
        outs.append(_affine(y, w, b, i, walk).to(p.dtype))
    return _wrap(walk, outs, x._sdim, x._scale, logical), (means, sqs, count)


def _batch_norm(walk: _Walk, func, args, kwargs):
    """``F.batch_norm``: with batch statistics over the batch and the
    spatial dims, two-pass over the shards, the running statistics (where
    given) updated as PyTorch updates them; with running statistics a
    per-channel affine, local."""
    a = _bind(args, kwargs, ("input", "running_mean", "running_var", "weight", "bias",
                             "training", "momentum", "eps"),
              {"running_mean": None, "running_var": None, "weight": None, "bias": None,
               "training": False, "momentum": 0.1, "eps": 1e-5})
    x = a["input"]
    logical = func(*_logicals(args), **_logicals(kwargs))
    stats = a["running_mean"] is not None
    if not a["training"]:
        return _same(walk, func, args, kwargs)
    if x._sdim is None or x._sdim == 1 or (stats and a["momentum"] is None):
        _refuse("F.batch_norm with batch statistics that the sharded dim does not span")
    dims = [0] + list(range(2, x._logical.ndim))
    out, (means, sqs, count) = _normalised(walk, x, dims, a["eps"], a["weight"], a["bias"],
                                           logical)
    if stats:
        mom, rm, rv = a["momentum"], a["running_mean"], a["running_var"]
        with torch.no_grad():
            rm.mul_(1.0 - mom).add_(means[0].reshape(-1).to(rm.device, rm.dtype), alpha=mom)
            unbiased = sqs[0].reshape(-1) / max(count - 1.0, 1.0)
            rv.mul_(1.0 - mom).add_(unbiased.to(rv.device, rv.dtype), alpha=mom)
    return out


def _instance_norm(walk: _Walk, func, args, kwargs):
    """``F.instance_norm`` with the input's statistics: two-pass over the
    spatial dims; with running statistics only, a local affine."""
    a = _bind(args, kwargs, ("input", "running_mean", "running_var", "weight", "bias",
                             "use_input_stats", "momentum", "eps"),
              {"running_mean": None, "running_var": None, "weight": None, "bias": None,
               "use_input_stats": True, "momentum": 0.1, "eps": 1e-5})
    x = a["input"]
    if not a["use_input_stats"]:
        return _same(walk, func, args, kwargs)
    if a["running_mean"] is not None:
        _refuse("F.instance_norm that tracks running statistics")
    if x._sdim is None or x._sdim < 2:
        _refuse("F.instance_norm of a shard list not sharded along a spatial dim")
    logical = func(*_logicals(args), **_logicals(kwargs))
    return _normalised(walk, x, list(range(2, x._logical.ndim)), a["eps"], a["weight"],
                       a["bias"], logical)[0]


def _group_norm(walk: _Walk, func, args, kwargs):
    """``F.group_norm``: each group's statistics over its channels and the
    spatial dims, two-pass over the shards."""
    a = _bind(args, kwargs, ("input", "num_groups", "weight", "bias", "eps"),
              {"weight": None, "bias": None, "eps": 1e-5})
    x, g = a["input"], a["num_groups"]
    if x._sdim is None or x._sdim < 2:
        _refuse("F.group_norm of a shard list not sharded along a spatial dim")
    logical = func(*_logicals(args), **_logicals(kwargs))

    def grouped(p):
        return p.reshape((p.shape[0], g, p.shape[1] // g) + tuple(p.shape[2:]))
    return _normalised(walk, x, list(range(2, x._logical.ndim + 1)), a["eps"], a["weight"],
                       a["bias"], logical, grouped)[0]


def _layer_norm(walk: _Walk, func, args, kwargs):
    """``F.layer_norm``: local over dims the sharded one is not among;
    over it two-pass, without an elementwise affine (whose weight would
    span the sharded dim)."""
    a = _bind(args, kwargs, ("input", "normalized_shape", "weight", "bias", "eps"),
              {"weight": None, "bias": None, "eps": 1e-5})
    x = a["input"]
    nd = x._logical.ndim
    dims = list(range(nd - len(a["normalized_shape"]), nd))
    if x._sdim is None or x._sdim not in dims:
        return _same(walk, func, args, kwargs)
    if a["weight"] is not None or a["bias"] is not None:
        _refuse("F.layer_norm over the sharded dim with an elementwise affine")
    logical = func(*_logicals(args), **_logicals(kwargs))
    return _normalised(walk, x, dims, a["eps"], None, None, logical)[0]


# -- windowed ops --------------------------------------------------------------

def _spatial_axis(x: ShardList, nd: int, name: str) -> int:
    ax = x._sdim - 2
    if not 0 <= ax < nd:
        _refuse(f"{name} with the sharded dim as a batch or channel dim")
    return ax


def _conv_pads(padding, ks: Sequence[int], dil: Sequence[int]) -> List[Tuple[int, int]]:
    if padding == "valid":
        return [(0, 0)] * len(ks)
    if padding == "same":
        out = []
        for k, d in zip(ks, dil):
            total = d * (k - 1)
            out.append((total // 2, total - total // 2))
        return out
    return [(p, p) for p in _tuple(padding, len(ks))]


def _conv(walk: _Walk, func, args, kwargs):
    """``F.conv1d/2d/3d``: over a halo of the planes its outputs read past
    each shard (zeros, or a pending pad's edge), unpadded along the axis,
    its other dims padded as asked; cuDNN's autograd, as unsharded."""
    name = _name(func)
    a = _bind(args, kwargs, ("input", "weight", "bias", "stride", "padding", "dilation",
                             "groups"),
              {"bias": None, "stride": 1, "padding": 0, "dilation": 1, "groups": 1})
    x, w, b = a["input"], a["weight"], a["bias"]
    if isinstance(w, ShardList) or isinstance(b, ShardList):
        _refuse(f"{name} with a shard list as its weight")
    logical = func(*_logicals(args), **_logicals(kwargs))
    if x._sdim is None:
        return _same(walk, func, args, kwargs)
    nd = w.ndim - 2
    ax = _spatial_axis(x, nd, name)
    ks, stride, dil = w.shape[2:], _tuple(a["stride"], nd), _tuple(a["dilation"], nd)
    pads = _conv_pads(a["padding"], ks, dil)
    k, s = dil[ax] * (ks[ax] - 1) + 1, stride[ax]
    xs, _, _, _, sizes = _windowed(walk, x, k, s, pads[ax], "zero", logical.shape[x._sdim],
                                   name)
    pads[ax] = (0, 0)
    if all(p == q for p, q in pads):
        padding, pre = tuple(p for p, _ in pads), None
    else:
        padding, pre = 0, [v for p in reversed(pads) for v in p]

    def conv(t: torch.Tensor, i: int) -> torch.Tensor:
        if pre is not None:
            t = F.pad(t, pre)
        return func(t, walk.place(w, i), None if b is None else walk.place(b, i), stride,
                    padding, dil, a["groups"])
    return _wrap(walk, on_shards(conv, xs, x._sdim, sizes), x._sdim, x._scale * s, logical)


def _conv_transpose(walk: _Walk, func, args, kwargs):
    """``F.conv_transpose1d/2d/3d`` whose output is its input times the
    stride: each shard with the input planes its outputs read past its ends
    (zeros at the volume's), cropped to its own stride x planes."""
    name = _name(func)
    a = _bind(args, kwargs, ("input", "weight", "bias", "stride", "padding",
                             "output_padding", "groups", "dilation"),
              {"bias": None, "stride": 1, "padding": 0, "output_padding": 0, "groups": 1,
               "dilation": 1})
    x, w = a["input"], a["weight"]
    logical = func(*_logicals(args), **_logicals(kwargs))
    if x._sdim is None:
        return _same(walk, func, args, kwargs)
    nd = w.ndim - 2
    ax = _spatial_axis(x, nd, name)
    s, p = _tuple(a["stride"], nd)[ax], _tuple(a["padding"], nd)[ax]
    k = _tuple(a["dilation"], nd)[ax] * (w.shape[2 + ax] - 1) + 1
    ext = x._logical.shape[x._sdim]
    lo, hi = (k - 1 - p) // s, (p + s - 1) // s
    if logical.shape[x._sdim] != s * ext or lo < 0:
        _refuse(f"{name} whose output along the sharded dim is not its input's times the "
                f"stride")
    rest = {n: a[n] for n in ("stride", "padding", "output_padding", "groups", "dilation")}
    sizes = [s * e for e in x._extents()]

    def deconv(t: torch.Tensor, i: int) -> torch.Tensor:
        y = func(t, walk.place(w, i), None if a["bias"] is None else walk.place(a["bias"], i),
                 **rest)
        return y.narrow(x._sdim, s * lo, sizes[i])
    xs = halo_exchange(x._parts, x._sdim - 2, lo, hi, "zero")
    return _wrap(walk, on_shards(deconv, xs, x._sdim, sizes), x._sdim, x._scale / s, logical)


def _pool(walk: _Walk, func, args, kwargs):
    """``F.max_pool*``/``F.avg_pool*``: a kernel equal to the stride and no
    padding is local; a padded or overlapping pool takes a halo (-inf for
    the max, zeros for the avg counting its padding, or a pending pad's
    edge)."""
    name = _name(func)
    is_max = "max" in name
    names = (("input", "kernel_size", "stride", "padding", "dilation", "ceil_mode",
              "return_indices") if is_max else
             ("input", "kernel_size", "stride", "padding", "ceil_mode", "count_include_pad",
              "divisor_override"))
    a = _bind(args, kwargs, names, {"stride": None, "padding": 0, "dilation": 1,
                                    "ceil_mode": False, "return_indices": False,
                                    "count_include_pad": True})
    x = a["input"]
    if a.get("return_indices"):
        _refuse(f"{name} with indices")
    logical = func(*_logicals(args), **_logicals(kwargs))
    if x._sdim is None:
        return _same(walk, func, args, kwargs)
    nd = x._logical.ndim - 2
    ax = _spatial_axis(x, nd, name)
    ks = _tuple(a["kernel_size"], nd)
    st = _tuple(a["stride"] if a["stride"] not in (None, [], ()) else a["kernel_size"], nd)
    pd, dil = _tuple(a["padding"], nd), _tuple(a["dilation"] if is_max else 1, nd)
    k, s = dil[ax] * (ks[ax] - 1) + 1, st[ax]
    if pd[ax] and not is_max and not a["count_include_pad"]:
        _refuse(f"{name} padded along the sharded dim without counting its padding")
    xs, _, _, _, sizes = _windowed(walk, x, k, s, (pd[ax], pd[ax]),
                                   "-inf" if is_max else "zero", logical.shape[x._sdim], name)
    call = {n: a[n] for n in names[1:] if n in a}
    call.update(kernel_size=ks, stride=st, padding=tuple(0 if d == ax else pd[d]
                                                        for d in range(nd)))
    return _wrap(walk, on_shards(lambda t, i: func(t, **call), xs, x._sdim, sizes), x._sdim,
                 x._scale * s, logical)


def _adaptive_pool(walk: _Walk, func, args, kwargs):
    """``F.adaptive_*_pool*``: to the input's extent along the axis, local;
    to one plane, the whole volume's mean (float32 sums) or max along it,
    then the pool over the other dims, replicated."""
    name = _name(func)
    a = _bind(args, kwargs, ("input", "output_size", "return_indices"),
              {"return_indices": False})
    x = a["input"]
    if a["return_indices"]:
        _refuse(f"{name} with indices")
    logical = func(*_logicals(args), **_logicals(kwargs))
    if x._sdim is None:
        return _same(walk, func, args, kwargs)
    nd = x._logical.ndim - 2
    ax = _spatial_axis(x, nd, name)
    size = list(_tuple(a["output_size"], nd))
    out_ext, ext = logical.shape[x._sdim], x._logical.shape[x._sdim]
    if out_ext == ext:
        size[ax] = None
        return _wrap(walk, on_shards(lambda p, i: func(p, tuple(size)), x._parts, x._sdim),
                     x._sdim, x._scale, logical)
    if out_ext != 1:
        _refuse(f"{name} to {out_ext} of {ext} planes along the sharded dim")
    if "max" in name:
        red = all_max(x._parts, [x._sdim])
    else:
        red = [t / ext for t in _sums(x._parts, [x._sdim])]
    size[ax] = 1
    return _replicated(walk, [func(r, tuple(size)) for r in red], logical)


_LINEAR = {"linear": 1, "bilinear": 1, "trilinear": 1, "bicubic": 2}


def _interpolate(walk: _Walk, func, args, kwargs):
    """``F.interpolate`` up by an integer r along the axis: nearest is
    local; a linear (bicubic) resize takes the resize's replicate halo of
    one (two) planes and crops r (2r) output planes on each side, which
    those planes alone decide."""
    name = _name(func)
    a = _bind(args, kwargs, ("input", "size", "scale_factor", "mode", "align_corners",
                             "recompute_scale_factor", "antialias"),
              {"size": None, "scale_factor": None, "mode": "nearest", "align_corners": None,
               "recompute_scale_factor": None, "antialias": False})
    x = a["input"]
    logical = func(*_logicals(args), **_logicals(kwargs))
    rest = {n: a[n] for n in ("scale_factor", "mode", "align_corners",
                              "recompute_scale_factor", "antialias")}
    if x._sdim is None:
        return _out(walk, [func(p, size=a["size"], **rest) for p in x._parts], logical,
                    None, None)
    nd = x._logical.ndim - 2
    ax = _spatial_axis(x, nd, name)
    ext, out_ext = x._logical.shape[x._sdim], logical.shape[x._sdim]
    if out_ext % ext:
        _refuse(f"{name} by a factor that is not a whole number along the sharded dim")
    r, mode = out_ext // ext, a["mode"]
    if mode in ("nearest", "nearest-exact") or r == 1:
        halo = 0
    elif mode in _LINEAR and not a["align_corners"] and not a["antialias"]:
        halo = _LINEAR[mode]
    else:
        _refuse(f"{name}(mode={mode!r}, align_corners={a['align_corners']}) along the "
                f"sharded dim")
    sizes = [r * e for e in x._extents()]

    def resize(t: torch.Tensor, i: int) -> torch.Tensor:
        size = a["size"]
        if size is not None:
            size = list(_tuple(size, nd))
            size[ax] = t.shape[x._sdim] * r
        y = func(t, size=size, **rest)
        return y.narrow(x._sdim, r * halo, sizes[i]) if halo else y
    xs = halo_exchange(x._parts, x._sdim - 2, halo, halo, "replicate")
    return _wrap(walk, on_shards(resize, xs, x._sdim, sizes), x._sdim, x._scale / r, logical)


def _pad(walk: _Walk, func, args, kwargs):
    """``F.pad``: along the other dims local; along the sharded dim zero,
    reflect or replicate padding stays pending on the list, for the next
    unpadded conv or pool to take as its halo."""
    a = _bind(args, kwargs, ("input", "pad", "mode", "value"),
              {"mode": "constant", "value": None})
    x = a["input"]
    logical = func(*_logicals(args), **_logicals(kwargs))
    if x._sdim is None:
        return _same(walk, func, args, kwargs)
    pad = list(a["pad"])
    j = 2 * (x._logical.ndim - 1 - x._sdim)
    lo, hi = (pad[j], pad[j + 1]) if j + 1 < len(pad) else (0, 0)
    if (lo, hi) == (0, 0):
        return _same(walk, func, args, kwargs)
    edge = {"reflect": "reflect", "replicate": "replicate"}.get(a["mode"])
    if a["mode"] == "constant" and not a["value"]:
        edge = "zero"
    if edge is None or lo < 0 or hi < 0:
        _refuse(f"F.pad(mode={a['mode']!r}, value={a['value']}) along the sharded dim")
    pad[j] = pad[j + 1] = 0
    parts = x._parts
    if any(pad):
        parts = [F.pad(p, pad, mode=a["mode"], value=a["value"]) for p in parts]
    return _wrap(walk, parts, x._sdim, x._scale, logical, pad=(lo, hi, edge))


def _dropout(walk: _Walk, func, args, kwargs):
    """``F.dropout`` and the feature dropouts: the noise (the kept mask over
    1 - p) drawn whole, once, on the first shard's device, where the
    unsharded module draws it, at the shape it draws (the whole tensor's,
    or its batch and channels for a feature dropout), and split."""
    name = _name(func)
    a = _bind(args, kwargs, ("input", "p", "training", "inplace"),
              {"p": 0.5, "training": True, "inplace": False})
    x = a["input"]
    logical = func(*_logicals(args), **_logicals(kwargs))
    if not a["training"] or a["p"] == 0.0:
        return _same(walk, func, args, kwargs)
    shape = list(logical.shape)
    if name != "F.dropout":
        want = {"F.dropout1d": 3, "F.dropout2d": 4, "F.dropout3d": 5}[name]
        if len(shape) != want:
            _refuse(f"{name} of a {len(shape)}-dim tensor")
        shape[2:] = [1] * (len(shape) - 2)
    ones = torch.ones(shape, dtype=logical.dtype, device=walk.mesh[0])
    noise = func(ones, a["p"], True)
    split = {}
    if name == "F.dropout" and x._sdim is not None:
        split[id(noise)] = (x._sdim, x._offsets())
    mul = torch.Tensor.mul_ if a["inplace"] else torch.mul
    return _out(walk, _per_part(walk, mul, (x, noise), {}, split), logical, x._sdim,
                x._scale)


# -- the port's own ops ----------------------------------------------------------

def _on_axis(walk: _Walk, x: ShardList, name: str) -> None:
    if x._sdim != walk.step.layout.dim:
        _refuse(f"{name} of a shard list sharded along dim {x._sdim}, not the volume's "
                f"axis")


def _conv_same(walk: _Walk, func, args, kwargs):
    """``conv_vjp.conv_same`` over a halo of the planes its outputs read
    past each shard (zeros, or a pending pad's edge): ``conv_halo`` for a
    symmetric zero halo at stride 1 (its dW on the wgrad kernel), else
    ``conv_same`` unpadded along the axis."""
    a = _bind(args, kwargs, ("x", "w", "stride", "padding"), {"stride": 1, "padding": 0})
    x, w, s = a["x"], a["w"], a["stride"]
    logical = func(*_logicals(args), **_logicals(kwargs))
    if x._sdim is None:
        return _same(walk, func, args, kwargs)
    nd = w.ndim - 2
    ax = _spatial_axis(x, nd, "conv_same")
    pads = list(_pairs(a["padding"], nd))
    k = w.shape[2 + ax]
    xs, lo, hi, edge, sizes = _windowed(walk, x, k, s, pads[ax], "zero",
                                        logical.shape[x._sdim], "conv_same")
    pads[ax] = (0, 0)
    ws = [walk.place(w, i) for i in range(len(xs))]
    if s == 1 and edge == "zero" and lo == hi == (k - 1) // 2 and lo:
        ys = on_shards(lambda t, i: conv_halo(t, ws[i], ax, pads), xs, x._sdim, sizes)
    else:
        ys = on_shards(lambda t, i: conv_same(t, ws[i], s, pads), xs, x._sdim, sizes)
    return _wrap(walk, ys, x._sdim, x._scale * s, logical)


def _upsample(walk: _Walk, func, args, kwargs):
    """``blocks.upsample``: by 2, ``ShardedStep._upsample`` (a linear mode
    over the resize's replicate halo, its backward the upsample kernel);
    nearest by another factor is local; a linear one ``F.interpolate``'s
    route."""
    a = _bind(args, kwargs, ("x", "factor", "mode"), {"factor": 2, "mode": "nearest"})
    x, factor, mode = a["x"], a["factor"], a["mode"]
    if x._sdim is None:
        return _same(walk, func, args, kwargs)
    if factor == 2:
        _on_axis(walk, x, "blocks.upsample")
        logical = func(*_logicals(args), **_logicals(kwargs))
        return _wrap(walk, walk.step._upsample(list(x._parts), mode), x._sdim,
                     x._scale / 2, logical)
    if mode == "nearest":
        return _repeat_free(walk, func, args, kwargs, Fraction(factor))
    lin = {1: "linear", 2: "bilinear", 3: "trilinear"}[x._logical.ndim - 2]
    return _interpolate(walk, F.interpolate, (x,), {"scale_factor": factor, "mode": lin,
                                                    "align_corners": False})


def _repeat_free(walk: _Walk, func, args, kwargs, factor: Fraction):
    """A port op that is local on shards lying on its blocks, its output
    planes ``factor`` times its input's along the axis: where ``factor`` <
    1 (``space_to_depth``) the shards are first relaid onto whole blocks
    (``spatial.rounded``; a shard may come out empty)."""
    x = args[0]
    logical = func(*_logicals(args), **_logicals(kwargs))
    if x._sdim is None:
        return _same(walk, func, args, kwargs)
    parts = x._parts
    if factor < 1:
        walk.need(x, int(1 / factor))
        parts = relayout(parts, x._sdim - 2, rounded(bounds_of(parts, x._sdim),
                                                      int(1 / factor)))
    return _wrap(walk, [func(p, *args[1:], **kwargs) for p in parts], x._sdim,
                 x._scale / factor, logical)


def _linear_upsample2x(walk: _Walk, func, args, kwargs):
    x = args[0]
    _on_axis(walk, x, "linear_upsample2x")
    logical = func(*_logicals(args), **_logicals(kwargs))
    return _wrap(walk, walk.step._upsample(list(x._parts), "linear"), x._sdim, x._scale / 2,
                 logical)


def _upsample_into_phase(walk: _Walk, func, args, kwargs):
    """``upsample_into_phase``: ``ShardedStep._upsample(into_phase=True)``;
    its output's grid is its input's."""
    a = _bind(args, kwargs, ("x", "mode"), {"mode": "nearest"})
    x = a["x"]
    _on_axis(walk, x, "upsample_into_phase")
    logical = func(*_logicals(args), **_logicals(kwargs))
    return _wrap(walk, walk.step._upsample(list(x._parts), a["mode"], into_phase=True),
                 x._sdim, x._scale, logical)


def _lanczos(walk: _Walk, func, args, kwargs):
    """``blocks.lanczos_downsample``: ``spatial_zoo._lanczos``, a replicate
    halo along the axis."""
    a = _bind(args, kwargs, ("x", "factor", "support"), {"support": 2})
    x = a["x"]
    _on_axis(walk, x, "lanczos_downsample")
    logical = func(*_logicals(args), **_logicals(kwargs))
    walk.need(x, a["factor"])
    ys = spatial_zoo._lanczos(walk.step, list(x._parts), a["factor"], a["support"])
    return _wrap(walk, ys, x._sdim, x._scale * a["factor"], logical)


# -- the tables ----------------------------------------------------------------

_LOGICAL_ATTRS = {getattr(torch._C.TensorBase, n) for n in (
    "shape", "ndim", "dtype", "layout", "is_sparse", "is_quantized")}
_PART_ATTRS = {getattr(torch._C.TensorBase, n) for n in ("device", "is_cuda", "is_cpu",
                                                          "is_meta")}
_READS = {getattr(torch.Tensor, n) for n in (
    "dim", "size", "numel", "nelement", "ndimension", "is_floating_point", "is_complex",
    "element_size", "is_contiguous", "__len__", "stride", "__format__", "is_signed")}
_READS.add(torch.numel)

_ELEMENTWISE = (
    "add", "sub", "subtract", "mul", "multiply", "div", "divide", "true_divide",
    "floor_divide", "remainder", "fmod", "pow", "float_power", "neg", "negative", "positive",
    "abs", "absolute", "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "sqrt",
    "rsqrt", "square", "reciprocal", "sign", "sgn", "sin", "cos", "tan", "tanh", "sinh",
    "cosh", "asin", "acos", "atan", "atan2", "sigmoid", "relu", "erf", "erfc", "floor", "ceil",
    "round", "trunc", "frac", "clamp", "clip", "clamp_min", "clamp_max", "where", "maximum",
    "minimum", "fmax", "fmin", "lerp", "addcmul", "addcdiv", "eq", "ne", "lt", "le", "gt", "ge",
    "logical_and", "logical_or", "logical_not", "logical_xor", "isnan", "isinf", "isfinite",
    "nan_to_num", "zeros_like", "ones_like", "full_like", "empty_like", "hypot", "xlogy",
    "logaddexp", "copysign", "masked_fill", "heaviside", "signbit")
_DUNDERS = (
    "__add__", "__radd__", "__iadd__", "__sub__", "__rsub__", "__isub__", "__mul__",
    "__rmul__", "__imul__", "__truediv__", "__rtruediv__", "__itruediv__", "__div__",
    "__rdiv__", "__floordiv__", "__rfloordiv__", "__mod__", "__rmod__", "__pow__", "__rpow__",
    "__ipow__", "__neg__", "__pos__", "__abs__", "__eq__", "__ne__", "__lt__", "__le__",
    "__gt__", "__ge__", "__and__", "__or__", "__xor__", "__invert__", "__rand__", "__ror__",
    "__rxor__")
_ACTIVATIONS = (
    "relu", "relu6", "elu", "selu", "celu", "gelu", "silu", "mish", "hardswish",
    "hardsigmoid", "hardtanh", "leaky_relu", "softplus", "softsign", "tanhshrink",
    "logsigmoid", "sigmoid", "tanh", "threshold", "hardshrink", "softshrink", "relu_",
    "elu_", "leaky_relu_", "hardtanh_", "threshold_")


def _table() -> Dict[Any, Callable]:
    t: Dict[Any, Callable] = {}

    def put(handler, *funcs):
        for f in funcs:
            if f is not None:
                t[f] = handler

    for n in _ELEMENTWISE:
        put(_elementwise, getattr(torch, n, None), getattr(torch.Tensor, n, None),
            getattr(torch.Tensor, n + "_", None))
    for n in _DUNDERS:
        put(_elementwise, getattr(torch.Tensor, n, None))
    for n in _ACTIVATIONS:
        put(_elementwise, getattr(F, n, None))
    put(_cast, *(getattr(torch.Tensor, n) for n in ("to", "type", "type_as", "float", "double",
                                                     "half", "bfloat16")))
    put(_same, torch.Tensor.contiguous, torch.Tensor.clone, torch.clone, torch.Tensor.detach,
        torch.detach)
    put(_new, *(getattr(torch.Tensor, n) for n in ("new_zeros", "new_ones", "new_full",
                                                    "new_empty", "new_tensor")))
    put(_reshape, torch.Tensor.view, torch.Tensor.view_as, torch.Tensor.reshape, torch.reshape,
        torch.Tensor.reshape_as, torch.Tensor.flatten, torch.flatten, torch.Tensor.unflatten,
        torch.unflatten, torch.Tensor.squeeze, torch.squeeze, torch.Tensor.unsqueeze,
        torch.unsqueeze)
    put(_permute, torch.Tensor.permute, torch.permute, torch.Tensor.transpose, torch.transpose,
        torch.Tensor.swapaxes, torch.swapaxes, torch.Tensor.swapdims, torch.swapdims,
        torch.Tensor.movedim, torch.movedim, torch.Tensor.moveaxis, torch.moveaxis)
    put(_expand, torch.Tensor.expand)
    put(_split(2), torch.Tensor.split, torch.split, torch.Tensor.chunk, torch.chunk)
    put(_split(1), torch.Tensor.narrow, torch.narrow)
    put(_split(1, drops=True), torch.Tensor.select, torch.select)
    put(_split(1, drops=True), torch.Tensor.unbind, torch.unbind)
    put(_flip, torch.flip, torch.Tensor.flip, torch.roll, torch.Tensor.roll)
    put(_getitem, torch.Tensor.__getitem__)
    put(_cat, torch.cat, torch.concat, torch.concatenate, torch.stack)
    put(_repeat_interleave, torch.repeat_interleave, torch.Tensor.repeat_interleave)
    put(_along(1, "dim"), F.softmax, F.log_softmax, torch.softmax, torch.log_softmax,
        torch.Tensor.softmax, torch.Tensor.log_softmax, torch.cumsum, torch.Tensor.cumsum)
    put(_along(1, "dim", -1), F.glu)
    put(_along(2, "dim", 1), F.normalize)
    put(_along(None, None, -1), F.linear)
    put(_along(None, None, 1), F.prelu)
    put(_sum_mean, torch.sum, torch.Tensor.sum, torch.mean, torch.Tensor.mean)
    put(_extreme, torch.amax, torch.Tensor.amax, torch.amin, torch.Tensor.amin, torch.max,
        torch.Tensor.max, torch.min, torch.Tensor.min)
    put(_var_std, torch.var, torch.Tensor.var, torch.std, torch.Tensor.std)
    put(_batch_norm, F.batch_norm)
    put(_instance_norm, F.instance_norm)
    put(_group_norm, F.group_norm)
    put(_layer_norm, F.layer_norm)
    put(_conv, torch.conv1d, torch.conv2d, torch.conv3d)
    put(_conv_transpose, torch.conv_transpose1d, torch.conv_transpose2d,
        torch.conv_transpose3d)
    put(_pool, F.max_pool1d, F.max_pool2d, F.max_pool3d, F.avg_pool1d, F.avg_pool2d,
        F.avg_pool3d)
    put(_adaptive_pool, F.adaptive_avg_pool1d, F.adaptive_avg_pool2d, F.adaptive_avg_pool3d,
        F.adaptive_max_pool1d, F.adaptive_max_pool2d, F.adaptive_max_pool3d)
    put(_interpolate, F.interpolate)
    put(_pad, F.pad)
    put(_dropout, F.dropout, F.dropout1d, F.dropout2d, F.dropout3d)
    put(_conv_same, conv_same)
    put(_upsample, blocks.upsample)
    put(_linear_upsample2x, linear_upsample2x)
    put(_upsample_into_phase, ps.upsample_into_phase)
    t[ps.space_to_depth] = lambda w, f, a, k: _repeat_free(w, f, a, k, Fraction(1, 2))
    t[ps.depth_to_space] = lambda w, f, a, k: _repeat_free(w, f, a, k, Fraction(2))
    put(_lanczos, blocks.lanczos_downsample)
    return t


_HANDLERS = _table()
_TAKE_PAD = {_conv, _pool, _conv_same}


# -- dispatch to the library's walks, the run, the meta pass -----------------------

def _child_block(m: nn.Module) -> int:
    """The planes each shard of a dispatched library net's input preferably
    holds a whole number of: the MulResUnet's 2^(L-1) (its phased levels'
    blocks), a zoo net's ``engine.solver.shard_block``, a block's largest
    stride."""
    cls = spatial_zoo.covered_class(m)
    if cls is MulResUnet:
        n = len(m.filters)
        return max([2 ** (n - 1)] + [2 ** (r + m.pdepth(r)) for r in range(n) if m.phased(r)])
    if cls in (spatial_zoo.SkipNet, spatial_zoo.UNet, spatial_zoo.PartialUNet,
               spatial_zoo.AttMulResUnet, spatial_zoo.AttentionUnet, spatial_zoo.Ensemble):
        from ..engine.solver import shard_block
        return shard_block(None, m)
    strides = [c.stride for c in m.modules() if isinstance(c, (Conv, ResNetBasicBlock))]
    strides += [2 for c in m.modules() if isinstance(c, Conv) and (c.phase_in or c.phase_out)]
    return max(strides, default=1)


def _dispatched(walk: _Walk, m: nn.Module, *args, **kwargs):
    """A covered library net's forward inside a caller's forward: its walk
    over the shards (``ShardedStep.child(m).walk``); on plain tensors, its
    own forward."""
    if not any(isinstance(a, ShardList) for a in itertools.chain(args, kwargs.values())):
        return type(m).forward(m, *args, **kwargs)
    dim = walk.step.layout.dim
    if kwargs or len(args) > 2 or any(not isinstance(a, ShardList) or a._sdim != dim
                                      or a._pad is not None for a in args):
        _refuse(f"{type(m).__name__} (a library net) called on other than shard lists "
                f"sharded along the volume's axis")
    x = args[0]
    walk.need(x, _child_block(m))
    ys = walk.step.child(m).walk(list(x._parts),
                                 list(args[1]._parts) if len(args) > 1 else None)
    out = _whole(walk, ys, dim)
    out._scale = x._scale * Fraction(x._logical.shape[dim], out._logical.shape[dim])
    return out


@contextlib.contextmanager
def _dispatching(model: nn.Module, walk: _Walk):
    """Bind the ``forward`` of each outermost child of ``model`` that a
    sharded walk covers to that walk, for the call."""
    bound: Dict[int, Tuple[nn.Module, Any]] = {}

    def visit(m: nn.Module) -> None:
        for c in m.children():
            if id(c) in bound:
                continue
            if spatial_zoo.covered_class(c) is None or (isinstance(c, FlaxConv)
                                                        and c.stride != 1):
                visit(c)
                continue
            bound[id(c)] = (c, c.__dict__.get("forward"))
            c.forward = functools.partial(_dispatched, walk, c)
    visit(model)
    try:
        yield
    finally:
        for c, old in bound.values():
            if old is None:
                del c.forward
            else:
                c.forward = old


def _run(walk: _Walk, call: Callable, xs: Shards, masks: Optional[Shards]) -> Shards:
    dim = walk.step.layout.dim
    args = [_whole(walk, xs, dim)]
    if masks is not None:
        args.append(_whole(walk, masks, dim))
    with _dispatching(walk.step.model, walk):
        out = call(*args)
    if (not isinstance(out, ShardList) or out._sdim != dim or out._pad is not None
            or out._logical.shape[dim] != args[0]._logical.shape[dim]):
        _refuse(f"a module's output ({type(out).__name__}) that is not sharded as its input")
    return list(out._parts)


def run(step: ShardedStep, xs: Shards, masks: Optional[Shards] = None) -> Shards:
    """The output shards of ``step.model``, a module of the caller's own,
    for the input shards ``xs`` (and, for a module that takes the mask,
    its shards ``masks``): its forward on shard lists, the parameters
    already replicated."""
    return _run(_Walk(step), step.model, xs, masks)


class _MetaLayout:
    """The shard layout a meta pass walks: ``n`` meta devices along
    spatial ``axis``."""

    def __init__(self, n: int, axis: int):
        self.mesh, self.axis, self.dim = [META] * n, axis, 2 + axis


def _widest(extent: int, n: int) -> int:
    """The widest block that splits ``extent`` planes into at least ``n``
    whole blocks (1 where the axis is shorter than ``n``)."""
    return next((b for b in range(extent // n, 0, -1) if extent % b == 0), 1)


def meta_pass(model: nn.Module, input_shape: Sequence[int], n: int, axis: int,
              takes_mask: bool = False, dtype: torch.dtype = torch.float32) -> int:
    """Run ``model``'s forward once over ``n`` meta shards of an input of
    ``input_shape`` along spatial ``axis`` (its parameters and buffers as
    meta tensors, nothing drawn), the shards on the widest block that
    splits the axis: raise ``NotImplementedError`` for the first op outside
    the walker's vocabulary, and return the shard block, the planes a shard
    holds a whole number of where the axis allows, so that every stride
    halves every shard. An axis shorter than the mesh is left to
    ``SpatialLayout`` to refuse."""
    shape = tuple(input_shape)
    if not 0 <= axis < len(shape) - 2 or shape[2 + axis] < n:
        return 1
    extent = shape[2 + axis]
    meta = {k: torch.empty_like(v, device=META)
            for k, v in itertools.chain(model.named_parameters(), model.named_buffers())}
    step = ShardedStep(model, _MetaLayout(n, axis))
    step._reps = {id(t): [t] * n for t in meta.values()}
    walk = _Walk(step)
    xs = []
    for a, b in shard_bounds(extent, n, _widest(extent, n)):
        sh = list(shape)
        sh[2 + axis] = b - a
        xs.append(torch.empty(sh, dtype=dtype, device=META))
    Compact.building = True
    try:
        with torch.enable_grad():
            _run(walk, lambda *a: functional_call(model, meta, a), xs,
                 xs if takes_mask else None)
    finally:
        Compact.building = False
    return walk.block
