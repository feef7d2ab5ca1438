"""A module of the caller's own over spatial shards (ROADMAP A.13c item 13,
A.13f).

The JAX package shards any flax module: its sharding is data placement,
and GSPMD partitions whatever the step computes; where it has no
partitioned form for an op, it gathers the operand and computes the op
whole. Here the caller's ``forward`` runs once a step on a ``ShardList``,
a tensor subclass whose value is a meta tensor of the whole logical shape
(so ``x.shape``, ``x.dim()`` and ``x.dtype`` read as in the unsharded
module) and which holds the list of shards, the sharded dim and a pending
edge pad. Every op the forward applies to it reaches
``ShardList.__torch_function__`` and takes one of four routes, chosen
from the op (the meta pass meets each before anything is drawn; a route
is never a fallback after a failure):

  * the vocabulary, whose sharded form of each op launches what its
    unsharded form launches:

    - a library net or block that a sharded walk covers
      (``spatial_zoo.covered_class``, a subclass that keeps its base's
      ``forward`` among them) takes that walk: for the call, the
      ``forward`` of each outermost such child is bound to
      ``ShardedStep.walk`` of a child step, so its parameters, halos,
      dropout draws and kernel launches are those of today's walks (a
      list off the walk's layout, or a plain tensor, is relaid or split
      onto it first);
    - local ops: elementwise ops and activations (complex parts too),
      casts, ``where``, ``clamp``, ``cat``/``stack`` along the other dims
      (two shard lists of one extent along the sharded dim but other
      bounds: the second relaid onto the first's, ``spatial.relayout``; a
      replicated operand that spans it: each copy's own planes), slicing
      and splits along the other dims, reductions, ``softmax`` and
      ``F.linear`` over them, reshapes that keep the sharded dim whole and
      its own, permutations, ``F.pad`` along the other dims, nearest
      ``F.interpolate`` by an integer;
    - spatial reductions: ``sum``/``mean`` over dims that hold the sharded
      one all-reduce the shards' float32 (float64) partial sums in shard
      order, ``amax``/``amin``/``max``/``min`` take ``all_max``, ``var``,
      ``std`` and the batch (batch statistics), instance, group and layer
      norms (without an affine over the sharded dim) the two-pass form (the
      mean, then the squared deviations from it), an adaptive pool to one
      plane along the axis the mean or the max. The result is a
      *replicated* list, one copy a shard; ops between replicated values
      are plain, and a replicated value broadcasts against shards;
    - the port's own ops (``conv_same``, ``blocks.upsample``,
      ``linear_upsample2x``, ``space_to_depth``, ``depth_to_space``,
      ``upsample_into_phase``, ``lanczos_downsample``) hand a
      ``__torch_function__`` tensor here at their entry, before their
      autograd Function: they take ``ShardedStep``'s pieces (``conv_halo``
      and the wgrad kernel, ``_upsample`` and the upsample kernel);

  * relayouts (``spatial.relayout``: each shard gets the planes of the
    result it holds, from whichever shards hold them; nothing is gathered):
    ``__getitem__`` with ints and step-1 slices along the sharded dim,
    ``narrow``, ``split``, ``chunk``, ``select`` and ``unbind`` along it,
    ``flip`` (each part reversed too), ``roll`` (a circular edge),
    ``cat`` along it, and a pending pad used by an op other than a conv or
    pool, materialised with its edge. A result of the input's extent lies
    on the input's bounds, any other on ``shard_bounds``' even split of its
    own extent (a shard may hold none); one plane, on every shard
    (replicated);
  * windows (``spatial.windows``: each shard owns the output planes whose
    first input plane it holds, the last shard those past the volume's
    end, and reads their window): ``F.conv*`` of any zero padding (an int,
    a tuple, ``'same'`` or ``'valid'``), stride and dilation along the
    axis, run unpadded along it through cuDNN's autograd, as the unsharded
    module runs it; ``F.pad`` zero, reflect, replicate or circular along
    the axis, kept pending on the list and taken by the next unpadded conv
    or pool as that edge's padding; max and average pools with any
    padding, ``ceil_mode`` and ``count_include_pad`` (-inf padding for the
    max; the average's divisor along the axis set per output plane as
    PyTorch counts it); linear ``F.interpolate`` by an integer (the
    resize's replicate halo: one plane, two for bicubic, the output planes
    they alone decide cropped); ``F.conv_transpose*`` of any padding,
    stride, dilation and output padding (each shard the input planes its
    outputs read, zeros past the volume's ends);
  * the whole route, for every other op with an operand that spans the
    sharded dim, as GSPMD runs an op it cannot partition: each such operand
    gathered whole on the first shard's device (``spatial._Gather``; a
    replicated list gives its copy 0), the op run on the whole tensors,
    and its result given back: split (``spatial.split``) along the
    sharded dim where it keeps the input's rank and spans more than one
    plane there (on the input's bounds where it keeps its extent, else on
    the even split of its own), else replicated. FFTs (complex results
    included), ``einsum`` and matmuls, ``softmax``/``cumsum``/``normalize``
    along the axis, reshapes that merge or split it, indices along it (a
    max pool's, ``sort``, ``topk``, ``max``), ``max_unpool*``,
    ``align_corners``, fractional and adaptive resizes to other extents, a
    layer norm whose affine spans the axis, a shard list as a conv weight,
    indexing by tensors, ``__setitem__`` and in-place ops on a shard list
    (its parts rebound to the result), a module output not sharded as its
    input. Each op that takes it is recorded on the step
    (``ShardedStep.whole_ops``: name, logical shape and dtype of the first
    gathered operand, bytes gathered).

Draws (``rand_like``, ``randn_like``, ``randint_like``, ``bernoulli``,
``normal``, in-place ``uniform_`` and the like, ``F.dropout`` of any rank
and its feature forms, ``F.alpha_dropout``, ``F.feature_alpha_dropout``)
are made whole at the logical shape on the first shard's device, from the
generator and in the order the unsharded module draws, and split: the
bits are the unsharded module's. Under ``torch.no_grad()`` (and after
``detach``) ops run on the parts as usual and autograd records nothing,
as ``jax.lax.stop_gradient``. A custom ``torch.autograd.Function``'s
``apply`` reaches no ``__torch_function__`` (only the ops inside its
forward do, with the gradient off, where they cannot tell it from a
``no_grad`` region): while the forward runs, ``Function.apply`` is bound
to a wrapper that sends shard-list arguments to the whole route, so the
Function's own forward and backward run as written on the whole tensors,
as GSPMD partitions a ``jax.custom_vjp``; the port's own Functions never
reach it with a shard list.

What stays refused, naming the op and ROADMAP D.4 (behaviours both
packages share), each where the JAX package's jitted step refuses it too:

  * ``.item()``, ``bool()``, ``int()``, ``float()``, ``.tolist()``,
    ``.numpy()``, ``torch.equal`` and the like of a shard list, or any op
    whose result is a Python value: a host read, ``jax.jit``'s
    ``ConcretizationTypeError``;
  * ``nonzero``, ``argwhere``, ``masked_select``, ``unique``, indexing by
    a boolean mask, and any op the meta pass cannot run on meta tensors:
    an output whose shape depends on values, which ``jax.jit`` cannot
    trace;
  * ``out=``, and an in-place op into a plain tensor: a flax module has
    neither (a ``jax.Array`` is immutable).

``meta_pass`` runs the forward once over meta shards before anything is
drawn: it meets every refusal and finds the shard block, the largest
product of the strides met along the axis on any path (a dispatched
child's own block scaled by the factor at its call): the shards lie on it
where the axis holds at least one block a shard, so every stride halves
every shard, and elsewhere they need not. A shard that holds no planes
(at a deep level of a fine split) launches nothing.
"""
from __future__ import annotations

import contextlib
import functools
import inspect
import itertools
import math
import numbers
from fractions import Fraction
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

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
from .spatial import (Bounds, ShardedStep, _Gather, all_max, all_reduce, bounds_of,
                      halo_exchange, on_shards, relayout, rounded, shard_bounds, split,
                      windows)

__all__ = ["ShardList", "WholeOp", "meta_pass", "run"]

D4 = "ROADMAP D.4"
META = torch.device("meta")
Shards = List[torch.Tensor]

HOST_READ = ("a host read of a value on the shards, which jax.jit refuses "
             "(ConcretizationTypeError)")
VALUE_SHAPE = ("an output whose shape depends on values (or an op the meta pass cannot run "
               "on meta tensors), which jax.jit cannot trace")
NO_OUT = "an out= or in-place write into a plain tensor, which a flax module cannot make"


def _refuse(what: str, why: str):
    raise NotImplementedError(f"{what} on spatial shards: {why} ({D4})")


class WholeOp(NamedTuple):
    """An op of a caller's module that took the whole route: its name, the
    logical shape and dtype of its first gathered operand, and the bytes
    gathered onto the first shard's device."""

    name: str
    shape: Tuple[int, ...]
    dtype: str
    bytes: int


class _Walk:
    """One run of a caller's forward over the shards: its step and the
    shard block its strides prefer."""

    def __init__(self, step: ShardedStep):
        self.step = step
        self.mesh = step.layout.mesh
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

    def record(self, name: str, gathered: Sequence["ShardList"]) -> None:
        first = gathered[0]._logical
        self.step.whole_ops.append(WholeOp(
            name, tuple(first.shape), str(first.dtype).replace("torch.", ""),
            sum(t._logical.numel() * t._logical.element_size() for t in gathered)))


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
        walk = lists[0]._walk
        if getattr(func, "__name__", None) == "__get__":
            return _attribute(walk, func, lists[0])
        if func in _READS:
            return func(*_logicals(args), **_logicals(kwargs))
        name = _name(func)
        if func in _HOST_READS:
            _refuse(name, HOST_READ)
        if func in _VALUE_SHAPES:
            _refuse(name, VALUE_SHAPE)
        if kwargs.get("out") is not None:
            _refuse(f"{name}(out=...)", NO_OUT)
        if _inplace(name) and args and not isinstance(args[0], ShardList):
            _refuse(f"{name} into a plain tensor", NO_OUT)
        handler = _HANDLERS.get(func, _whole_op)
        if handler not in _TAKE_PAD:
            args, kwargs = _materialised_all(walk, (args, kwargs))
        return handler(walk, func, args, kwargs)

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


def _mapped(obj, fn):
    """``obj`` (an op's arguments) with each tensor ``t`` as ``fn(t)``."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (list, tuple)) and not isinstance(obj, torch.Size):
        return type(obj)(_mapped(o, fn) for o in obj)
    if isinstance(obj, dict):
        return {k: _mapped(v, fn) for k, v in obj.items()}
    return obj


def _logicals(obj):
    """``obj`` with each tensor as a meta tensor of its (logical) shape."""
    return _mapped(obj, _meta)


def _logical(func, args, kwargs, name: Optional[str] = None):
    """``func`` on the logical (meta) tensors: the result's shape and dtype.
    An op the meta device cannot run (an output whose shape depends on
    values) is refused."""
    try:
        return func(*_logicals(args), **_logicals(kwargs))
    except NotImplementedError as e:
        if D4 in str(e):
            raise
        _refuse(name or _name(func), VALUE_SHAPE)


def _map(obj, i: int, walk: _Walk, split: Dict[int, Tuple[int, List[int]]]):
    """``obj`` for shard ``i``: a shard list's part, a plain tensor placed
    on its device, or its slice (a replicated list's copy's) where
    ``split`` says it spans the sharded dim (dim, offsets)."""
    if isinstance(obj, torch.Tensor):
        s = split.get(id(obj))
        t = obj._parts[i] if isinstance(obj, ShardList) else obj
        if s is not None:
            dim, offs = s
            t = t.narrow(dim, offs[i], offs[i + 1] - offs[i])
        return t if isinstance(obj, ShardList) else walk.place(t, i)
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


_SUBMODULES = {"torch._C._fft": ("fft", "fft_"), "torch._C._linalg": ("linalg", "linalg_"),
               "torch._C._special": ("special", "special_"), "torch._C._nested": ("nested", "")}


def _name(func) -> str:
    n = getattr(func, "__name__", None) or repr(func)
    q = getattr(func, "__qualname__", "") or ""
    mod = getattr(func, "__module__", "") or ""
    if q.startswith(("TensorBase.", "Tensor.")):
        return f"Tensor.{n}"
    if mod.startswith("torch.nn.functional") or mod == "torch._C._nn":
        return f"F.{n}"
    if mod in _SUBMODULES:
        sub, prefix = _SUBMODULES[mod]
        return f"torch.{sub}.{n[len(prefix):] if n.startswith(prefix) else n}"
    if mod.startswith("deep_prior_interpolation_tpu_torch"):
        return n
    return f"torch.{n}"


_INPLACE_DUNDERS = frozenset({
    "__setitem__", "__iadd__", "__isub__", "__imul__", "__itruediv__", "__ifloordiv__",
    "__imod__", "__ipow__", "__iand__", "__ior__", "__ixor__", "__ilshift__", "__irshift__",
    "__imatmul__"})


def _inplace(name: str) -> bool:
    short = name.rsplit(".", 1)[-1]
    return short in _INPLACE_DUNDERS or (short.endswith("_") and not short.startswith("__"))


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


# -- layouts, relayouts, the whole route ------------------------------------------

def _spread(extent: int, n: int) -> Bounds:
    """The planes each of ``n`` shards holds of a new axis of ``extent``
    planes: ``shard_bounds``' even split; where the axis is shorter than
    the mesh, one plane for each of the first shards and none for the
    rest."""
    if extent >= n:
        return shard_bounds(extent, n)
    return [(min(i, extent), min(i + 1, extent)) for i in range(n)]


def _relay(walk: _Walk, x: ShardList, extent: int, source: int, edge: str = "zero",
           flip: bool = False) -> Shards:
    """The parts of a result of ``extent`` planes along ``x``'s sharded dim
    whose plane q is ``x``'s plane ``source + q`` (with ``flip``, ``source
    - q``; past ``x``'s ends as ``edge`` gives them), relaid from the
    shards that hold them (``spatial.relayout``): on ``x``'s bounds where
    the extent is ``x``'s, a copy of the one plane on every shard where it
    is 1 (a replicated value), else on the even split of its own."""
    ext, n = x._logical.shape[x._sdim], len(walk.mesh)
    if extent == ext:
        bounds = bounds_of(x._parts, x._sdim)
    elif extent == 1:
        bounds = [(0, 1)] * n
    else:
        bounds = _spread(extent, n)
    if flip:
        targets = [(source - b + 1, source - a + 1) for a, b in bounds]
    else:
        targets = [(source + a, source + b) for a, b in bounds]
    parts = relayout(x._parts, x._sdim - 2, targets, edge)
    return [p.flip(x._sdim) for p in parts] if flip else parts


def _kept(x: ShardList, extent: int) -> Optional[int]:
    """The sharded dim of a relaid result of ``extent`` planes: None (a
    replicated value) for one plane from more."""
    return None if extent == 1 != x._logical.shape[x._sdim] else x._sdim


def _materialised(walk: _Walk, x: ShardList) -> ShardList:
    """A shard list with a pending pad as the padded tensor's planes, each
    past the volume's ends as the pad's edge gives it (a relayout onto the
    even split of the padded extent)."""
    lo, _, edge = x._pad
    bounds = _spread(x._logical.shape[x._sdim], len(walk.mesh))
    parts = relayout(x._parts, x._sdim - 2, [(a - lo, b - lo) for a, b in bounds], edge)
    return _wrap(walk, parts, x._sdim, x._scale, x._logical)


def _materialised_all(walk: _Walk, obj):
    if not any(isinstance(t, ShardList) and t._pad is not None for t in _leaves(obj)):
        return obj
    return _mapped(obj, lambda t: _materialised(walk, t)
                   if isinstance(t, ShardList) and t._pad is not None else t)


def _replicate(walk: _Walk, t: torch.Tensor) -> ShardList:
    """A whole tensor as a replicated list: itself on the first shard, a
    copy on each other (autograd sums their gradients)."""
    parts = [t] + [t.to(d, copy=True) for d in walk.mesh[1:]]
    return _wrap(walk, parts, None, None, _meta(t))


def _back(walk: _Walk, t: torch.Tensor, src: ShardList) -> ShardList:
    """A whole result given back to the shards: split (``spatial.split``)
    along ``src``'s sharded dim where it keeps ``src``'s rank and spans
    more than one plane there, on ``src``'s bounds where it keeps its
    extent, else on the even split of its own; else replicated."""
    sd = src._sdim
    if sd is None or t.ndim != src._logical.ndim or t.shape[sd] <= 1:
        return _replicate(walk, t)
    ext, src_ext = t.shape[sd], src._logical.shape[sd]
    bounds = bounds_of(src._parts, sd) if ext == src_ext else _spread(ext, len(walk.mesh))
    return _wrap(walk, split(t, sd, bounds, walk.mesh), sd,
                 src._scale * Fraction(src_ext, ext), _meta(t))


def _retyped(out, vals: list):
    """``vals`` in the sequence type of ``out`` (a tuple, a list, a named
    tuple or a ``torch.return_types`` structure)."""
    if type(out) in (tuple, list):
        return type(out)(vals)
    return type(out)(*vals) if hasattr(out, "_fields") else type(out)(vals)


def _back_all(walk: _Walk, out, src: ShardList, name: str):
    """``_back`` of each tensor an op returned (a tuple or a named tuple of
    them keeps its type); a Python value is a host read, refused."""
    if out is None:
        return None
    if isinstance(out, torch.Tensor):
        return _back(walk, out, src)
    if isinstance(out, (tuple, list)) and all(o is None or isinstance(o, torch.Tensor)
                                              for o in out):
        return _retyped(out, [None if o is None else _back(walk, o, src) for o in out])
    _refuse(name, HOST_READ)


def _gathered(walk: _Walk, t: ShardList) -> torch.Tensor:
    """A sharded list whole on the first shard's device (``_Gather``), in
    its logical strides: the unsharded module's layout, which an op that
    fills memory in order (a draw) or picks its algorithm by it sees."""
    w = _Gather.apply(t._sdim, walk.mesh[0], *t._parts)
    if w.stride() != t._logical.stride():
        w = torch.empty_like(t._logical, device=walk.mesh[0]).copy_(w)
    return w


def _whole_op(walk: _Walk, func, args, kwargs, name: Optional[str] = None,
              record: bool = True):
    """The whole route: each operand that spans the sharded dim gathered
    whole on the first shard's device (``_Gather``; a replicated list's
    copy 0, a plain tensor placed there), ``func`` run on the whole
    tensors, and its result given back (``_back``). An in-place op on a
    shard list rebinds its parts to the result. With no sharded operand
    (replicated lists only) the op runs on each copy."""
    name = name or _name(func)
    args, kwargs = _materialised_all(walk, (args, kwargs))
    if not name.endswith(".apply"):   # a Function's forward runs once, whole
        _logical(func, args, kwargs, name)
    sharded: List[ShardList] = []
    for t in _leaves((args, kwargs)):
        if isinstance(t, ShardList) and t._sdim is not None and all(t is not u for u in sharded):
            sharded.append(t)
    if not sharded:
        return _per_copy(walk, func, args, kwargs, name)
    dev = walk.mesh[0]
    target = args[0] if _inplace(name) and isinstance(args[0], ShardList) else None
    wholes: Dict[int, torch.Tensor] = {}

    def whole(t: torch.Tensor) -> torch.Tensor:
        if not isinstance(t, ShardList):
            return walk.place(t, 0)
        if id(t) not in wholes:
            if t._sdim is not None:
                wholes[id(t)] = _gathered(walk, t)
            else:   # an in-place op's own copy, so the other copies stay
                wholes[id(t)] = t._parts[0].clone() if t is target else t._parts[0]
        return wholes[id(t)]
    wargs, wkwargs = _mapped((args, kwargs), whole)
    try:
        out = func(*wargs, **wkwargs)
    except (NotImplementedError, RuntimeError) as e:   # a Function's forward on meta
        if dev.type != "meta" or D4 in str(e) or "meta" not in str(e).lower():
            raise
        _refuse(name, VALUE_SHAPE)
    if record:
        walk.record(name, sharded)
    src = sharded[0]
    if target is None:
        return _back_all(walk, out, src, name)
    new = _back(walk, wholes[id(target)], target) if target._sdim is not None \
        else _replicate(walk, wholes[id(target)])
    target._parts = new._parts
    return target if out is wholes[id(target)] else _back_all(walk, out, src, name)


def _per_copy(walk: _Walk, func, args, kwargs, name: str):
    """An op on replicated lists alone: run on each copy."""
    results = _per_part(walk, func, args, kwargs)
    r = results[0]
    if r is None:
        return None
    if isinstance(r, torch.Tensor):
        return _wrap(walk, results, None, None, _meta(r))
    if isinstance(r, (tuple, list)) and all(isinstance(o, torch.Tensor) for o in r):
        return _retyped(r, [_wrap(walk, [q[k] for q in results], None, None, _meta(o))
                            for k, o in enumerate(r)])
    _refuse(name, HOST_READ)


def _windowed(walk: _Walk, x: ShardList, k: int, s: int, pad: Tuple[int, int], edge: str,
              out_ext: int) -> Tuple[Shards, int, int, str, List[int]]:
    """Each shard's window of the outputs it owns (``spatial.windows``) of a
    window of ``k`` planes at stride ``s`` with ``out_ext`` outputs: its
    padding (``pad``, whose planes follow ``edge``) or a pending pad's (and
    its edge) before and after the volume; a pending pad under padding of
    the op's own is materialised first. Returns the windows, ``lo``,
    ``hi``, the edge and each shard's output planes."""
    lo, hi = pad
    if x._pad is not None and tuple(pad) != (0, 0):
        x = _materialised(walk, x)
    if x._pad is not None:
        lo, hi, edge = x._pad
    walk.need(x, s)
    xs, out = windows(x._parts, x._sdim - 2, k, s, lo, edge, out_ext)
    return xs, lo, hi, edge, [d - c for c, d in out]


# -- the vocabulary ------------------------------------------------------------

_TRANSPOSES = {"T": lambda t: t.T, "mT": lambda t: t.mT, "H": lambda t: t.H,
               "mH": lambda t: t.mH}


def _attribute(walk: _Walk, func, x: ShardList):
    """A property read: the logical tensor's, the device that of the first
    shard, ``requires_grad`` any shard's; ``real``, ``imag`` and ``data``
    of each part; the transposes as permutations."""
    desc = func.__self__
    if desc in _LOGICAL_ATTRS:
        return func(x._logical)
    if desc in _PART_ATTRS:
        return func(x._parts[0])
    if desc is torch._C.TensorBase.requires_grad:
        return any(p.requires_grad for p in x._parts)
    attr = getattr(desc, "__name__", "")
    if attr in ("real", "imag", "data"):
        return _out(walk, [func(p) for p in x._parts], func(x._logical), x._sdim, x._scale)
    if attr in _TRANSPOSES:
        return _permute(walk, _TRANSPOSES[attr], (x,), {})
    return func(x._logical)


def _elementwise(walk: _Walk, func, args, kwargs):
    """An elementwise op (broadcasting): each shard with its own slice of
    any operand that spans the sharded dim, a replicated copy of the rest;
    operands sharded otherwise take the whole route."""
    logical = _logical(func, args, kwargs)
    if not isinstance(logical, torch.Tensor):
        return _whole_op(walk, func, args, kwargs)
    leaves = [t for t in _leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
    aligned = _aligned(leaves, logical)
    moved = None if aligned is None else _onto_first(walk, (args, kwargs))
    if moved is None:
        return _whole_op(walk, func, args, kwargs)
    args, kwargs = moved
    sd, split_, scale = aligned
    return _out(walk, _per_part(walk, func, args, kwargs, split_), logical, sd, scale)


def _onto_first(walk: _Walk, obj):
    """``obj`` (an op's arguments) with each shard list sharded as the
    first one but on other bounds relaid onto the first's bounds; None
    where one spans the sharded dim otherwise (another extent, or another
    dim counted from the last)."""
    sharded = [t for t in _leaves(obj) if isinstance(t, ShardList) and t._sdim is not None]
    if not sharded:
        return obj
    ref = sharded[0]
    bounds = bounds_of(ref._parts, ref._sdim)
    other = [t for t in sharded[1:] if bounds_of(t._parts, t._sdim) != bounds]
    if any(t._logical.ndim - t._sdim != ref._logical.ndim - ref._sdim
           or bounds_of(t._parts, t._sdim)[-1][1] != bounds[-1][1] for t in other):
        return None
    moved = {id(t): _wrap(walk, relayout(t._parts, t._sdim - 2, bounds), t._sdim, t._scale,
                          t._logical) for t in other}
    return _mapped(obj, lambda t: moved.get(id(t), t)) if moved else obj


def _aligned(leaves: Sequence[torch.Tensor], out: torch.Tensor):
    """The output's sharded dim (None: replicated), the plain operands and
    replicated lists to split as the shards lie, and the scale, for
    operands broadcast to ``out``; None where shard lists lie along
    different dims."""
    nd = out.ndim
    sharded = [t for t in leaves if isinstance(t, ShardList) and t._sdim is not None]
    if not sharded:
        return None, {}, None
    dims = {t._sdim + nd - t._logical.ndim for t in sharded}
    if len(dims) != 1:
        return None
    sd, src = dims.pop(), sharded[0]
    split_ = {}
    for t in leaves:
        if isinstance(t, ShardList) and t._sdim is not None:
            continue
        shape = _meta(t).shape
        j = sd - (nd - len(shape))
        if j < 0 or shape[j] == 1:
            continue
        split_[id(t)] = (j, src._offsets())
    return sd, split_, src._scale


def _same(walk: _Walk, func, args, kwargs):
    """An op that keeps its input's layout (a copy, a cast of its own)."""
    x = args[0]
    logical = _logical(func, args, kwargs)
    return _out(walk, _per_part(walk, func, args, kwargs), logical, x._sdim, x._scale)


def _along(pos: Optional[int], key: Optional[str], default=None):
    """An op along one dim (``softmax``, ``cumsum``, ``F.normalize``;
    ``F.linear`` on the last dim, ``F.prelu`` on the channels, which take
    no ``pos``): local where that dim is not the sharded one, else the
    whole route."""
    def handler(walk: _Walk, func, args, kwargs):
        x = args[0]
        d = default
        if pos is not None:
            d = args[pos] if len(args) > pos else kwargs.get(key, default)
        if x._sdim is not None and (d is None or _dim(d, x._logical.ndim) == x._sdim):
            return _whole_op(walk, func, args, kwargs)
        logical = _logical(func, args, kwargs)
        return _out(walk, _per_part(walk, func, args, kwargs), logical, x._sdim, x._scale)
    return handler


def _cast(walk: _Walk, func, args, kwargs):
    """``to``/``type``/``type_as``, the dtype methods, ``cpu``/``cuda``: a
    cast of each part; a device move leaves each part on its shard's
    device."""
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
    if dtype is None or dtype == x._logical.dtype:
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
    of extents before it; one that merges or splits it takes the whole
    route."""
    x, name = args[0], _name(func)
    if name == "Tensor.view" and len(args) == 2 and isinstance(args[1], torch.dtype):
        if args[1].itemsize != x._logical.dtype.itemsize:
            return _whole_op(walk, func, args, kwargs)
        return _same(walk, func, args, kwargs)
    logical = _logical(func, args, kwargs)
    if x._sdim is None:
        return _out(walk, _per_part(walk, func, args, kwargs), logical, None, None)
    src, dst, d = list(x._logical.shape), list(logical.shape), x._sdim
    before = math.prod(src[:d])
    out = next((k for k in range(len(dst))
                if dst[k] == src[d] and math.prod(dst[:k]) == before), None)
    if out is None:
        return _whole_op(walk, func, args, kwargs)
    parts = []
    for p in x._parts:
        shape = list(dst)
        shape[out] = p.shape[d]
        parts.append(p.reshape(shape))
    return _wrap(walk, parts, out, x._scale, logical)


_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def _permute(walk: _Walk, func, args, kwargs):
    """A permutation of the dims (``permute``, ``transpose``, ``movedim``,
    the transposes): where the sharded dim lands, from the op on a meta
    tensor of distinct extents."""
    x = args[0]
    logical = _logical(func, args, kwargs)
    sd = None
    if x._sdim is not None:
        probe = torch.empty(_PRIMES[:x._logical.ndim], device=META)
        sd = list(func(probe, *args[1:], **kwargs).shape).index(_PRIMES[x._sdim])
    return _out(walk, _per_part(walk, func, args, kwargs), logical, sd, x._scale)


def _expand(walk: _Walk, func, args, kwargs):
    """``expand``: the sharded dim keeps each shard's extent."""
    x = args[0]
    logical = _logical(func, args, kwargs)
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
    sharded one; along it, each piece's planes relaid (``_relay``), a
    picked plane on every shard."""
    def handler(walk: _Walk, func, args, kwargs):
        x = args[0]
        d = args[pos] if len(args) > pos else kwargs.get("dim", default)
        logical = _logical(func, args, kwargs)
        sd = x._sdim
        if sd is None or _dim(d, x._logical.ndim) != sd:
            if sd is not None and drops and _dim(d, x._logical.ndim) < sd:
                sd -= 1
            return _out(walk, _per_part(walk, func, args, kwargs), logical, sd, x._scale)
        short, ext = _name(func).rsplit(".", 1)[-1], x._logical.shape[sd]
        if short == "unbind":   # every plane on every shard
            parts = relayout(x._parts, sd - 2, [(0, ext)] * len(walk.mesh))
            return tuple(_wrap(walk, [p.select(sd, q) for p in parts], None, None, t)
                         for q, t in enumerate(logical))
        if short == "select":
            i = _bind(args, kwargs, ("input", "dim", "index"), {})["index"]
            parts = _relay(walk, x, 1, i + ext if i < 0 else i)
            return _wrap(walk, [p.select(sd, 0) for p in parts], None, None, logical)
        if short == "narrow":
            start = _bind(args, kwargs, ("input", "dim", "start", "length"), {})["start"]
            pieces, starts = [logical], [start + ext if start < 0 else start]
        else:
            pieces = list(logical)
            starts = list(itertools.accumulate([0] + [t.shape[sd] for t in pieces[:-1]]))
        outs = tuple(_wrap(walk, _relay(walk, x, t.shape[sd], a), _kept(x, t.shape[sd]),
                           x._scale, t) for a, t in zip(starts, pieces))
        return outs[0] if short == "narrow" else outs
    return handler


def _flip(walk: _Walk, func, args, kwargs):
    """``flip``/``roll``: local along dims other than the sharded one;
    along it relaid (a flip reverses each part too, a roll's planes wrap
    round the volume's ends); a roll without dims rolls the flattened
    tensor, the whole route."""
    x, name = args[0], _name(func)
    roll = name.endswith("roll")
    a = _bind(args, kwargs, ("input", "shifts", "dims") if roll else ("input", "dims"),
              {"dims": None})
    sd, nd = x._sdim, x._logical.ndim
    if roll and a["dims"] is None:
        return _whole_op(walk, func, args, kwargs) if sd is not None \
            else _same(walk, func, args, kwargs)
    dims = [_dim(d, nd) for d in _listed(a["dims"])]
    if sd is None or sd not in dims:
        return _same(walk, func, args, kwargs)
    logical = _logical(func, args, kwargs)
    ext = x._logical.shape[sd]
    if roll:
        shifts = _listed(a["shifts"])
        shift = sum(s for s, d in zip(shifts, dims) if d == sd) % ext
        parts = _relay(walk, x, ext, -shift, "circular")
        rest = [(s, d) for s, d in zip(shifts, dims) if d != sd]
        if rest:
            parts = [torch.roll(p, [s for s, _ in rest], [d for _, d in rest]) for p in parts]
    else:
        parts = _relay(walk, x, ext, ext - 1, flip=True)
        rest = [d for d in dims if d != sd]
        if rest:
            parts = [p.flip(rest) for p in parts]
    return _wrap(walk, parts, sd, x._scale, logical)


def _listed(v) -> list:
    return list(v) if isinstance(v, (list, tuple)) else [v]


def _getitem(walk: _Walk, func, args, kwargs):
    """Indexing by ints, slices, None and Ellipsis: local along the other
    dims; along the sharded dim an int picks a plane onto every shard (a
    replicated value) and a step-1 slice is relaid (``_relay``); a tensor,
    list or bool index, or a slice of another step, takes the whole
    route."""
    x, idx = args
    items = idx if isinstance(idx, tuple) else (idx,)
    if not all(i is None or i is Ellipsis or _int(i) or (isinstance(i, slice) and all(
            v is None or _int(v) for v in (i.start, i.stop, i.step))) for i in items):
        return _whole_op(walk, func, args, kwargs)
    logical = func(x._logical, idx)
    if x._sdim is None:
        return _wrap(walk, [p[idx] for p in x._parts], None, None, logical)
    nd = x._logical.ndim
    used = sum(1 for i in items if i is not None and i is not Ellipsis)
    full = []
    for i in items:
        full += [slice(None)] * (nd - used) if i is Ellipsis else [i]
    k, sd, d_in, d_out = None, None, 0, 0
    for pos, i in enumerate(full):
        if i is None:
            d_out += 1
            continue
        if d_in == x._sdim:
            k, sd = pos, (d_out if isinstance(i, slice) else None)
        d_out += isinstance(i, slice)
        d_in += 1
    if k is None:   # the sharded dim past the indexed ones: whole
        return _wrap(walk, [p[idx] for p in x._parts], d_out + x._sdim - d_in, x._scale,
                     logical)
    it, ext, parts = full[k], x._logical.shape[x._sdim], x._parts
    if isinstance(it, numbers.Integral):
        parts = _relay(walk, x, 1, int(it) + ext if it < 0 else int(it))
        full[k] = 0
    else:
        start, stop, step = it.indices(ext)
        if step != 1:
            return _whole_op(walk, func, args, kwargs)
        count = max(stop - start, 0)
        if (start, count) != (0, ext):
            parts = _relay(walk, x, count, start)
            full[k] = slice(None)
            sd = None if count == 1 else sd
    return _wrap(walk, [p[tuple(full)] for p in parts], sd, x._scale, logical)


def _int(v) -> bool:
    return isinstance(v, numbers.Integral) and not isinstance(v, bool)


def _cat(walk: _Walk, func, args, kwargs):
    """``cat``/``stack``: along any dim but the sharded one local; ``cat``
    along it one relayout of every operand's planes laid end to end (a
    plain tensor or replicated list split first), onto the even split of
    the result."""
    name = _name(func)
    tensors = args[0] if args else kwargs["tensors"]
    d = args[1] if len(args) > 1 else kwargs.get("dim", kwargs.get("axis", 0))
    logical = _logical(func, args, kwargs)
    sharded = [t for t in tensors if isinstance(t, ShardList) and t._sdim is not None]
    if not sharded:
        return _out(walk, _per_part(walk, func, args, kwargs), logical, None, None)
    sds = {t._sdim for t in sharded}
    if len(sds) != 1:
        return _whole_op(walk, func, args, kwargs)
    sd, src = sds.pop(), sharded[0]
    stack = "stack" in name
    d = _dim(d, src._logical.ndim + stack)
    if not stack and d == sd:
        ext, n, parts = logical.shape[sd], len(walk.mesh), []
        for t in tensors:
            if not (isinstance(t, ShardList) and t._sdim is not None):
                w = t._parts[0] if isinstance(t, ShardList) else walk.place(t, 0)
                t = _wrap(walk, split(w, sd, _spread(w.shape[sd], n), walk.mesh), sd,
                          src._scale, _meta(w))
            parts += [p.to(logical.dtype) for p in t._parts]
        targets = _spread(ext, n) + [(ext, ext)] * (len(parts) - n)
        return _wrap(walk, relayout(parts, sd - 2, targets)[:n], sd, src._scale, logical)
    moved = _onto_first(walk, (args, kwargs))
    if moved is None:
        return _whole_op(walk, func, args, kwargs)
    args, kwargs = moved
    tensors = args[0] if args else kwargs["tensors"]
    split_ = {}
    for t in tensors:
        if isinstance(t, ShardList) and t._sdim is not None:
            continue
        if _meta(t).shape[sd] != src._logical.shape[sd]:
            return _whole_op(walk, func, args, kwargs)
        split_[id(t)] = (sd, src._offsets())
    out_sd = sd + (stack and d <= sd)
    return _wrap(walk, _per_part(walk, func, args, kwargs, split_), out_sd, src._scale, logical)


def _repeat_interleave(walk: _Walk, func, args, kwargs):
    """``repeat_interleave`` by an int along one dim (the sharded one too:
    a nearest upsample); by a tensor or over the flattened tensor, the
    whole route."""
    a = _bind(args, kwargs, ("input", "repeats", "dim"), {"dim": None})
    x = a["input"]
    if not isinstance(a["repeats"], int) or a["dim"] is None:
        return _whole_op(walk, func, args, kwargs)
    logical = _logical(func, args, kwargs)
    scale = x._scale
    if x._sdim is not None and _dim(a["dim"], x._logical.ndim) == x._sdim:
        scale = scale / a["repeats"]
    return _out(walk, _per_part(walk, func, args, kwargs), logical, x._sdim, scale)


def _complex_view(walk: _Walk, func, args, kwargs):
    """``view_as_real`` (a last dim of 2 added) and ``view_as_complex`` (it
    taken away): local where the sharded dim is not the one taken away."""
    x = args[0]
    logical = _logical(func, args, kwargs)
    if x._sdim is not None and x._sdim >= logical.ndim:
        return _whole_op(walk, func, args, kwargs)
    return _out(walk, _per_part(walk, func, args, kwargs), logical, x._sdim, x._scale)


def _iterate(walk: _Walk, func, args, kwargs):
    """Iteration over dim 0: its ``unbind``."""
    return iter(torch.unbind(args[0], 0))


def _hash(walk: _Walk, func, args, kwargs):
    """A shard list hashes by identity, as a tensor does."""
    return id(args[0])


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
    logical = _logical(func, args, kwargs)
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
    dim (values and indices; over the sharded dim, whose indices span it,
    the whole route); ``max(x, y)`` is elementwise. Over the sharded dim
    the whole volume's extreme (``all_max``)."""
    x, name = args[0], _name(func)
    low = name.endswith("min")
    arg = args[1] if len(args) > 1 else kwargs.get("dim", kwargs.get("other"))
    if isinstance(arg, torch.Tensor):
        return _elementwise(walk, func, args, kwargs)
    nd = x._logical.ndim
    if not name.endswith(("amax", "amin")) and arg is not None:   # values and indices
        if x._sdim is not None and _dim(arg, nd) == x._sdim:
            return _whole_op(walk, func, args, kwargs)
        logical = _logical(func, args, kwargs)
        keep = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
        sd = x._sdim
        if sd is not None and not keep and _dim(arg, nd) < sd:
            sd -= 1
        results = _per_part(walk, func, args, kwargs)
        return type(logical)(tuple(_wrap(walk, [r[k] for r in results], sd, x._scale, t)
                                   for k, t in enumerate(logical)))
    logical = _logical(func, args, kwargs)
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
    logical = _logical(func, args, kwargs)
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
    per-channel affine, local; statistics the sharded dim does not span
    (or a cumulative average), the whole route."""
    a = _bind(args, kwargs, ("input", "running_mean", "running_var", "weight", "bias",
                             "training", "momentum", "eps"),
              {"running_mean": None, "running_var": None, "weight": None, "bias": None,
               "training": False, "momentum": 0.1, "eps": 1e-5})
    x = a["input"]
    stats = a["running_mean"] is not None
    if not a["training"]:
        return _same(walk, func, args, kwargs)
    if x._sdim is None or x._sdim == 1 or (stats and a["momentum"] is None):
        return _whole_op(walk, func, args, kwargs)
    logical = _logical(func, args, kwargs)
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
    spatial dims; with running statistics only, a local affine; tracking
    running statistics, or sharded along the batch or channels, the whole
    route."""
    a = _bind(args, kwargs, ("input", "running_mean", "running_var", "weight", "bias",
                             "use_input_stats", "momentum", "eps"),
              {"running_mean": None, "running_var": None, "weight": None, "bias": None,
               "use_input_stats": True, "momentum": 0.1, "eps": 1e-5})
    x = a["input"]
    if not a["use_input_stats"]:
        return _same(walk, func, args, kwargs)
    if a["running_mean"] is not None or x._sdim is None or x._sdim < 2:
        return _whole_op(walk, func, args, kwargs)
    logical = _logical(func, args, kwargs)
    return _normalised(walk, x, list(range(2, x._logical.ndim)), a["eps"], a["weight"],
                       a["bias"], logical)[0]


def _group_norm(walk: _Walk, func, args, kwargs):
    """``F.group_norm``: each group's statistics over its channels and the
    spatial dims, two-pass over the shards (sharded along the batch or
    channels, the whole route)."""
    a = _bind(args, kwargs, ("input", "num_groups", "weight", "bias", "eps"),
              {"weight": None, "bias": None, "eps": 1e-5})
    x, g = a["input"], a["num_groups"]
    if x._sdim is None or x._sdim < 2:
        return _whole_op(walk, func, args, kwargs)
    logical = _logical(func, args, kwargs)

    def grouped(p):
        return p.reshape((p.shape[0], g, p.shape[1] // g) + tuple(p.shape[2:]))
    return _normalised(walk, x, list(range(2, x._logical.ndim + 1)), a["eps"], a["weight"],
                       a["bias"], logical, grouped)[0]


def _layer_norm(walk: _Walk, func, args, kwargs):
    """``F.layer_norm``: local over dims the sharded one is not among;
    over it two-pass without an elementwise affine, and with one (whose
    weight spans the sharded dim) the whole route."""
    a = _bind(args, kwargs, ("input", "normalized_shape", "weight", "bias", "eps"),
              {"weight": None, "bias": None, "eps": 1e-5})
    x = a["input"]
    nd = x._logical.ndim
    dims = list(range(nd - len(a["normalized_shape"]), nd))
    if x._sdim is None or x._sdim not in dims:
        return _same(walk, func, args, kwargs)
    if a["weight"] is not None or a["bias"] is not None:
        return _whole_op(walk, func, args, kwargs)
    logical = _logical(func, args, kwargs)
    return _normalised(walk, x, dims, a["eps"], None, None, logical)[0]


# -- windowed ops --------------------------------------------------------------

def _axis_of(x: ShardList, nd: int) -> Optional[int]:
    """The spatial axis of ``x``'s sharded dim for an op over ``nd``
    spatial dims; None where it is a batch or channel dim."""
    ax = x._sdim - 2
    return ax if 0 <= ax < nd else None


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
    """``F.conv1d/2d/3d`` of any padding, stride and dilation along the
    axis: each shard's window of the outputs it owns (zeros, or a pending
    pad's edge), unpadded along the axis, its other dims padded as asked;
    cuDNN's autograd, as unsharded. A shard list as its weight takes the
    whole route."""
    a = _bind(args, kwargs, ("input", "weight", "bias", "stride", "padding", "dilation",
                             "groups"),
              {"bias": None, "stride": 1, "padding": 0, "dilation": 1, "groups": 1})
    x, w, b = a["input"], a["weight"], a["bias"]
    if not isinstance(x, ShardList) or isinstance(w, ShardList) or isinstance(b, ShardList):
        return _whole_op(walk, func, args, kwargs)
    logical = _logical(func, args, kwargs)
    if x._sdim is None:
        return _same(walk, func, args, kwargs)
    nd = w.ndim - 2
    ax = _axis_of(x, nd)
    if ax is None:
        return _whole_op(walk, func, args, kwargs)
    ks, stride, dil = w.shape[2:], _tuple(a["stride"], nd), _tuple(a["dilation"], nd)
    pads = _conv_pads(a["padding"], ks, dil)
    k, s = dil[ax] * (ks[ax] - 1) + 1, stride[ax]
    xs, _, _, _, sizes = _windowed(walk, x, k, s, pads[ax], "zero", logical.shape[x._sdim])
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
    """``F.conv_transpose1d/2d/3d``: each shard owns the output planes
    ``stride`` times its input planes (the last also those past them) and
    runs the deconv, without its bias and output padding along the axis,
    on a window of the input planes they read (zeros past the volume's
    ends) wide enough for them, then crops it to them and adds the
    bias."""
    a = _bind(args, kwargs, ("input", "weight", "bias", "stride", "padding",
                             "output_padding", "groups", "dilation"),
              {"bias": None, "stride": 1, "padding": 0, "output_padding": 0, "groups": 1,
               "dilation": 1})
    x, w, bias = a["input"], a["weight"], a["bias"]
    if not isinstance(x, ShardList) or isinstance(w, ShardList) or isinstance(bias, ShardList):
        return _whole_op(walk, func, args, kwargs)
    logical = _logical(func, args, kwargs)
    if x._sdim is None:
        return _same(walk, func, args, kwargs)
    nd = w.ndim - 2
    ax = _axis_of(x, nd)
    if ax is None:
        return _whole_op(walk, func, args, kwargs)
    sd = x._sdim
    s, p = _tuple(a["stride"], nd)[ax], _tuple(a["padding"], nd)[ax]
    reach = _tuple(a["dilation"], nd)[ax] * (w.shape[2 + ax] - 1)
    ext, out_ext = x._logical.shape[sd], logical.shape[sd]
    rest = {n: a[n] for n in ("stride", "padding", "groups", "dilation")}
    out = [(min(s * a_, out_ext), min(s * b_, out_ext)) for a_, b_ in bounds_of(x._parts, sd)]
    out[-1] = (out[-1][0], out_ext)
    starts, targets = [], []
    for c, d in out:
        i0 = min(c, c + p - reach) // s
        width = max((d - 1 + p) // s + 1 - i0, -(-(d - s * i0 + 2 * p - reach - 1) // s) + 1, 1)
        starts.append(i0)
        targets.append((i0, i0 + width) if d > c else (i0, i0))
    xs = relayout(x._parts, sd - 2, targets)
    rest["output_padding"] = tuple(0 if j == ax else v for j, v in
                                   enumerate(_tuple(a["output_padding"], nd)))
    shape = (1, -1) + (1,) * nd

    def deconv(t: torch.Tensor, i: int) -> torch.Tensor:
        c, d = out[i]
        y = func(t, walk.place(w, i), None, **rest).narrow(sd, c - s * starts[i], d - c)
        return y if bias is None else y + walk.place(bias, i).view(shape)
    return _wrap(walk, on_shards(deconv, xs, sd, [d - c for c, d in out]), sd,
                 x._scale * Fraction(ext, out_ext), logical)


def _pool(walk: _Walk, func, args, kwargs):
    """``F.max_pool*``/``F.avg_pool*`` of any kernel, stride, padding and
    ``ceil_mode``: each shard's window of the outputs it owns (-inf for the
    max, zeros for the avg, or a pending pad's edge); an average's divisor
    along the axis set per output plane as PyTorch counts it (its padding
    counted or not, a ``ceil_mode`` window clipped at the end). A max
    pool's indices span the volume: the whole route."""
    name = _name(func)
    is_max = "max" in name
    names = (("input", "kernel_size", "stride", "padding", "dilation", "ceil_mode",
              "return_indices") if is_max else
             ("input", "kernel_size", "stride", "padding", "ceil_mode", "count_include_pad",
              "divisor_override"))
    a = _bind(args, kwargs, names, {"stride": None, "padding": 0, "dilation": 1,
                                    "ceil_mode": False, "return_indices": False,
                                    "count_include_pad": True, "divisor_override": None})
    x = a["input"]
    if a.get("return_indices") or not isinstance(x, ShardList):
        return _whole_op(walk, func, args, kwargs)
    logical = _logical(func, args, kwargs)
    if x._sdim is None:
        return _same(walk, func, args, kwargs)
    nd = x._logical.ndim - 2
    ax = _axis_of(x, nd)
    if ax is None:
        return _whole_op(walk, func, args, kwargs)
    if a["ceil_mode"] and x._pad is not None:   # windows past the pad read -inf or nothing
        x = _materialised(walk, x)
    ks = _tuple(a["kernel_size"], nd)
    st = _tuple(a["stride"] if a["stride"] not in (None, [], ()) else a["kernel_size"], nd)
    pd, dil = _tuple(a["padding"], nd), _tuple(a["dilation"] if is_max else 1, nd)
    k, s, p = dil[ax] * (ks[ax] - 1) + 1, st[ax], pd[ax]
    ext, out_ext = x._logical.shape[x._sdim], logical.shape[x._sdim]
    xs, _, _, _, sizes = _windowed(walk, x, k, s, (p, p), "-inf" if is_max else "zero",
                                   out_ext)
    call = {n: a[n] for n in names[1:] if n in a}
    call.update(kernel_size=ks, stride=st, padding=tuple(0 if d == ax else pd[d]
                                                        for d in range(nd)))
    ys = on_shards(lambda t, i: func(t, **call), xs, x._sdim, sizes)
    if not is_max and a["divisor_override"] is None:
        def count(o: int) -> int:
            start = o * s - p
            if a["count_include_pad"]:
                return min(start + k, ext + p) - start
            return min(start + k, ext) - max(start, 0)
        counts = [count(o) for o in range(out_ext)]
        if any(c != k for c in counts):
            firsts = list(itertools.accumulate([0] + sizes[:-1]))
            view = [1] * (nd + 2)
            ys = [y if not size else y * torch.tensor(
                [k / c for c in counts[o:o + size]], dtype=y.dtype, device=y.device).view(
                    view[:x._sdim] + [size] + view[x._sdim + 1:])
                  for y, o, size in zip(ys, firsts, sizes)]
    return _wrap(walk, ys, x._sdim, x._scale * s, logical)


def _adaptive_pool(walk: _Walk, func, args, kwargs):
    """``F.adaptive_*_pool*``: to the input's extent along the axis, local;
    to one plane, the whole volume's mean (float32 sums) or max along it,
    then the pool over the other dims, replicated; to another extent, or
    with indices, the whole route."""
    a = _bind(args, kwargs, ("input", "output_size", "return_indices"),
              {"return_indices": False})
    x = a["input"]
    if a["return_indices"]:
        return _whole_op(walk, func, args, kwargs)
    logical = _logical(func, args, kwargs)
    if x._sdim is None:
        return _same(walk, func, args, kwargs)
    nd = x._logical.ndim - 2
    ax = _axis_of(x, nd)
    out_ext, ext = logical.shape[x._sdim], x._logical.shape[x._sdim]
    if ax is None or out_ext not in (ext, 1):
        return _whole_op(walk, func, args, kwargs)
    size = list(_tuple(a["output_size"], nd))
    if out_ext == ext:
        size[ax] = None
        return _wrap(walk, on_shards(lambda p, i: func(p, tuple(size)), x._parts, x._sdim),
                     x._sdim, x._scale, logical)
    if "max" in _name(func):
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
    those planes alone decide. Any other resize along the axis
    (``align_corners``, antialiasing, a fraction, ``'area'``) takes the
    whole route."""
    a = _bind(args, kwargs, ("input", "size", "scale_factor", "mode", "align_corners",
                             "recompute_scale_factor", "antialias"),
              {"size": None, "scale_factor": None, "mode": "nearest", "align_corners": None,
               "recompute_scale_factor": None, "antialias": False})
    x = a["input"]
    logical = _logical(func, args, kwargs)
    rest = {n: a[n] for n in ("scale_factor", "mode", "align_corners",
                              "recompute_scale_factor", "antialias")}
    if x._sdim is None:
        return _out(walk, [func(p, size=a["size"], **rest) for p in x._parts], logical,
                    None, None)
    nd = x._logical.ndim - 2
    ax = _axis_of(x, nd)
    ext, out_ext = x._logical.shape[x._sdim], logical.shape[x._sdim]
    r, mode = out_ext // ext, a["mode"]
    if ax is None or out_ext % ext:
        return _whole_op(walk, func, args, kwargs)
    if mode in ("nearest", "nearest-exact") or r == 1:
        halo = 0
    elif mode in _LINEAR and not a["align_corners"] and not a["antialias"]:
        halo = _LINEAR[mode]
    else:
        return _whole_op(walk, func, args, kwargs)
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


_EDGES = {"reflect": "reflect", "replicate": "replicate", "circular": "circular"}


def _pad(walk: _Walk, func, args, kwargs):
    """``F.pad``: along the other dims local; along the sharded dim zero,
    reflect, replicate or circular padding stays pending on the list, for
    the next unpadded conv or pool to take as its halo (any other op
    materialises it); a constant of another value, or a crop, takes the
    whole route."""
    a = _bind(args, kwargs, ("input", "pad", "mode", "value"),
              {"mode": "constant", "value": None})
    x = a["input"]
    logical = _logical(func, args, kwargs)
    if x._sdim is None:
        return _same(walk, func, args, kwargs)
    pad = list(a["pad"])
    j = 2 * (x._logical.ndim - 1 - x._sdim)
    lo, hi = (pad[j], pad[j + 1]) if j + 1 < len(pad) else (0, 0)
    if (lo, hi) == (0, 0):
        return _same(walk, func, args, kwargs)
    edge = _EDGES.get(a["mode"])
    if a["mode"] == "constant" and not a["value"]:
        edge = "zero"
    if edge is None or lo < 0 or hi < 0:
        return _whole_op(walk, func, args, kwargs)
    pad[j] = pad[j + 1] = 0
    parts = x._parts
    if any(pad):
        parts = [F.pad(p, pad, mode=a["mode"], value=a["value"]) for p in parts]
    return _wrap(walk, parts, x._sdim, x._scale, logical, pad=(lo, hi, edge))


# -- draws -----------------------------------------------------------------------

def _given(walk: _Walk, t: torch.Tensor, x: ShardList) -> ShardList:
    """A tensor drawn whole at ``x``'s logical shape, split as ``x`` lies
    (replicated for a replicated ``x``)."""
    if x._sdim is None:
        return _replicate(walk, t)
    return _wrap(walk, split(t, x._sdim, bounds_of(x._parts, x._sdim), walk.mesh), x._sdim,
                 x._scale, _meta(t))


def _like(walk: _Walk, func, args, kwargs):
    """``rand_like``, ``randn_like``, ``randint_like``: drawn whole at the
    logical shape and strides (a draw fills memory in order) on the first
    shard's device, as the unsharded module draws it, and split."""
    x = args[0]
    whole = torch.empty_like(x._logical, device=walk.mesh[0])
    return _given(walk, func(whole, *args[1:], **kwargs), x)


def _inplace_draw(walk: _Walk, func, args, kwargs):
    """``uniform_``, ``normal_``, ``bernoulli_`` and the other in-place
    draws into a shard list: drawn into a whole tensor of its logical shape
    on the first shard's device (a shard-list probability gathered), split,
    and the list's parts rebound to the draw."""
    x = args[0]
    whole = torch.empty_like(x._logical, device=walk.mesh[0])
    rest = _mapped((args[1:], kwargs), lambda t: _gathered(walk, t)
                   if isinstance(t, ShardList) and t._sdim is not None
                   else (t._parts[0] if isinstance(t, ShardList) else walk.place(t, 0)))
    func(whole, *rest[0], **rest[1])
    x._parts = _given(walk, whole, x)._parts
    return x


def _drawn(walk: _Walk, func, args, kwargs):
    """``bernoulli``, ``normal``, ``poisson`` of a shard list: its values
    gathered whole on the first shard's device, drawn there as the
    unsharded module draws, and split (the whole route, not recorded: a
    draw's gather)."""
    return _whole_op(walk, func, args, kwargs, record=False)


_FEATURE_RANK = {"F.dropout1d": 3, "F.dropout2d": 4, "F.dropout3d": 5}


def _dropout(walk: _Walk, func, args, kwargs):
    """``F.dropout`` and the feature dropouts, of any rank: the noise (the
    kept mask over 1 - p) drawn whole, once, on the first shard's device,
    where the unsharded module draws it, at the shape and strides it draws
    (the whole tensor's, or its batch and channels for a feature dropout of
    its rank), and split where it spans the sharded dim."""
    name = _name(func)
    a = _bind(args, kwargs, ("input", "p", "training", "inplace"),
              {"p": 0.5, "training": True, "inplace": False})
    x = a["input"]
    logical = _logical(func, args, kwargs)
    if not a["training"] or a["p"] == 0.0:
        return _same(walk, func, args, kwargs)
    ones = torch.ones_like(logical, device=walk.mesh[0])
    if _FEATURE_RANK.get(name) == logical.ndim:
        shape = list(logical.shape[:2]) + [1] * (logical.ndim - 2)
        ones = torch.ones(shape, dtype=logical.dtype, device=walk.mesh[0])
    noise = func(ones, a["p"], True)
    mul = torch.Tensor.mul_ if a["inplace"] else torch.mul
    return _noised(walk, lambda t, n: mul(t, n), x, logical, noise)


def _noised(walk: _Walk, fn, x: ShardList, logical: torch.Tensor, *noise) -> ShardList:
    """``fn(part, *noise)`` on each shard, each noise tensor split where it
    spans the sharded dim."""
    split_ = {}
    if x._sdim is not None:
        split_ = {id(t): (x._sdim, x._offsets()) for t in noise
                  if t.ndim == logical.ndim and t.shape[x._sdim] == logical.shape[x._sdim] > 1}
    return _out(walk, _per_part(walk, fn, (x,) + noise, {}, split_), logical, x._sdim,
                x._scale)


_ALPHA = 1.7580993408473766   # the SELU's alpha, as ATen's alpha dropout takes it


def _alpha_dropout(walk: _Walk, func, args, kwargs):
    """``F.alpha_dropout`` and ``F.feature_alpha_dropout``: ATen's formula
    on a keep mask drawn whole on the first shard's device at the shape
    and strides ATen draws (the whole tensor's, or its batch and channels), split where
    it spans the sharded dim: the unsharded module's bits."""
    a = _bind(args, kwargs, ("input", "p", "training", "inplace"),
              {"p": 0.5, "training": False, "inplace": False})
    x, p = a["input"], a["p"]
    logical = _logical(func, args, kwargs)
    if not a["training"] or p == 0.0:
        return _same(walk, func, args, kwargs)
    if p == 1.0:
        zero = torch.zeros((), dtype=logical.dtype, device=walk.mesh[0])
        return _noised(walk, torch.mul, x, logical, zero)
    noise = torch.empty_like(logical, device=walk.mesh[0])
    if "feature" in _name(func):
        shape = list(logical.shape[:2]) + [1] * (logical.ndim - 2)
        noise = torch.empty(shape, dtype=logical.dtype, device=walk.mesh[0])
    noise.bernoulli_(1 - p)
    scale = 1.0 / math.sqrt((_ALPHA * _ALPHA * p + 1) * (1 - p))
    shift = noise.add(-1).mul_(_ALPHA * scale).add_(_ALPHA * scale * p)
    noise.mul_(scale)
    return _noised(walk, lambda t, n, b: torch.mul(t, n).add_(b), x, logical, noise, shift)


# -- the port's own ops ----------------------------------------------------------

def _on_axis(walk: _Walk, x: ShardList) -> bool:
    return x._sdim == walk.step.layout.dim


def _conv_same(walk: _Walk, func, args, kwargs):
    """``conv_vjp.conv_same`` over a halo of the planes its outputs read
    past each shard (zeros, or a pending pad's edge): ``conv_halo`` for a
    symmetric zero halo at stride 1 (its dW on the wgrad kernel), else
    ``conv_same`` unpadded along the axis."""
    a = _bind(args, kwargs, ("x", "w", "stride", "padding"), {"stride": 1, "padding": 0})
    x, w, s = a["x"], a["w"], a["stride"]
    if not isinstance(x, ShardList) or isinstance(w, ShardList):
        return _whole_op(walk, func, args, kwargs)
    logical = _logical(func, args, kwargs)
    if x._sdim is None:
        return _same(walk, func, args, kwargs)
    nd = w.ndim - 2
    ax = _axis_of(x, nd)
    if ax is None:
        return _whole_op(walk, func, args, kwargs)
    pads = list(_pairs(a["padding"], nd))
    k = w.shape[2 + ax]
    xs, lo, hi, edge, sizes = _windowed(walk, x, k, s, pads[ax], "zero",
                                        logical.shape[x._sdim])
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
        if not _on_axis(walk, x):
            return _whole_op(walk, func, args, kwargs)
        logical = _logical(func, args, kwargs)
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
    logical = _logical(func, args, kwargs)
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
    if not _on_axis(walk, x):
        return _whole_op(walk, func, args, kwargs)
    logical = _logical(func, args, kwargs)
    return _wrap(walk, walk.step._upsample(list(x._parts), "linear"), x._sdim, x._scale / 2,
                 logical)


def _upsample_into_phase(walk: _Walk, func, args, kwargs):
    """``upsample_into_phase``: ``ShardedStep._upsample(into_phase=True)``;
    its output's grid is its input's."""
    a = _bind(args, kwargs, ("x", "mode"), {"mode": "nearest"})
    x = a["x"]
    if not _on_axis(walk, x):
        return _whole_op(walk, func, args, kwargs)
    logical = _logical(func, args, kwargs)
    return _wrap(walk, walk.step._upsample(list(x._parts), a["mode"], into_phase=True),
                 x._sdim, x._scale, logical)


def _lanczos(walk: _Walk, func, args, kwargs):
    """``blocks.lanczos_downsample``: ``spatial_zoo._lanczos``, a replicate
    halo along the axis."""
    a = _bind(args, kwargs, ("x", "factor", "support"), {"support": 2})
    x = a["x"]
    if not _on_axis(walk, x):
        return _whole_op(walk, func, args, kwargs)
    logical = _logical(func, args, kwargs)
    walk.need(x, a["factor"])
    ys = spatial_zoo._lanczos(walk.step, list(x._parts), a["factor"], a["support"])
    return _wrap(walk, ys, x._sdim, x._scale * a["factor"], logical)


# -- the tables ----------------------------------------------------------------

def _attrs(owner, names) -> set:
    return {getattr(owner, n) for n in names if hasattr(owner, n)}


_LOGICAL_ATTRS = _attrs(torch._C.TensorBase, (
    "shape", "ndim", "dtype", "layout", "is_sparse", "is_quantized"))
_PART_ATTRS = _attrs(torch._C.TensorBase, ("device", "is_cuda", "is_cpu", "is_meta"))
_READS = _attrs(torch.Tensor, (
    "dim", "size", "numel", "nelement", "ndimension", "is_floating_point", "is_complex",
    "element_size", "is_contiguous", "__len__", "stride", "__format__", "is_signed"))
_READS.add(torch.numel)
_HOST_READS = _attrs(torch.Tensor, (
    "item", "tolist", "numpy", "__bool__", "__int__", "__float__", "__index__",
    "__complex__", "__array__", "__contains__", "equal", "allclose", "is_nonzero",
    "data_ptr")) | {torch.equal, torch.allclose, torch.is_nonzero}
_VALUE_SHAPES = _attrs(torch.Tensor, (
    "nonzero", "argwhere", "masked_select", "unique", "unique_consecutive")) | {
    torch.nonzero, torch.argwhere, torch.masked_select, torch.unique,
    torch.unique_consecutive}

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
    "logaddexp", "copysign", "masked_fill", "heaviside", "signbit", "real", "imag", "conj",
    "conj_physical", "resolve_conj", "resolve_neg", "angle", "complex", "polar")
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
_IN_PLACE_DRAWS = ("uniform_", "normal_", "bernoulli_", "exponential_", "geometric_",
                   "log_normal_", "cauchy_", "random_")


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
                                                     "half", "bfloat16", "cpu", "cuda")))
    put(_same, torch.Tensor.contiguous, torch.Tensor.clone, torch.clone, torch.Tensor.detach,
        torch.detach, torch.Tensor.requires_grad_)
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
    put(_complex_view, torch.view_as_real, torch.view_as_complex)
    put(_iterate, torch.Tensor.__iter__)
    put(_hash, torch.Tensor.__hash__)
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
    put(_alpha_dropout, F.alpha_dropout, F.feature_alpha_dropout)
    put(_like, torch.rand_like, torch.randn_like, torch.randint_like)
    put(_inplace_draw, *(getattr(torch.Tensor, n, None) for n in _IN_PLACE_DRAWS))
    put(_drawn, torch.bernoulli, torch.Tensor.bernoulli, torch.normal, torch.poisson)
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


# -- dispatch to the library's walks, custom Functions, the run, the meta pass -----

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


def _on_layout(walk: _Walk, t, what: str, like: Optional[ShardList] = None) -> Shards:
    """``t`` as shards along the volume's axis: a shard list sharded there
    as it lies (onto ``like``'s bounds where given), any other (sharded
    otherwise, gathered as the whole route ``what``; replicated; plain)
    split onto ``like``'s bounds or the even split of its extent."""
    dim = walk.step.layout.dim
    if isinstance(t, ShardList) and t._pad is not None:
        t = _materialised(walk, t)
    bounds = None if like is None else bounds_of(like._parts, dim)
    if isinstance(t, ShardList) and t._sdim == dim:
        return t._parts if bounds is None else relayout(t._parts, dim - 2, bounds)
    if isinstance(t, ShardList) and t._sdim is not None:
        w = _gathered(walk, t)
        walk.record(what, [t])
    else:
        w = t._parts[0] if isinstance(t, ShardList) else walk.place(t, 0)
    if bounds is None:
        bounds = _spread(w.shape[dim], len(walk.mesh))
    return split(w, dim, bounds, walk.mesh)


def _dispatched(walk: _Walk, m: nn.Module, *args, **kwargs):
    """A covered library net's forward inside a caller's forward: its walk
    over the shards (``ShardedStep.child(m).walk``), its input (and mask)
    relaid or split onto the volume's axis first where they lie otherwise;
    on plain tensors, its own forward."""
    if not any(isinstance(a, ShardList) for a in _leaves((args, kwargs))):
        return type(m).forward(m, *args, **kwargs)
    dim = walk.step.layout.dim
    bound = inspect.signature(type(m).forward).bind(m, *args, **kwargs)
    bound.apply_defaults()
    pos = [v for k, v in bound.arguments.items() if k != "self"]
    x, mask = pos[0], (pos[1] if len(pos) > 1 else None)
    what = f"{type(m).__name__}'s input"
    xs = _on_layout(walk, x, what)
    whole = _whole(walk, xs, dim)
    masks = None if mask is None else _on_layout(walk, mask, what, whole)
    if isinstance(x, ShardList) and x._sdim == dim:
        whole._scale = x._scale
    walk.need(whole, _child_block(m))
    ys = walk.step.child(m).walk(list(xs), None if masks is None else list(masks))
    out = _whole(walk, ys, dim)
    out._scale = whole._scale * Fraction(whole._logical.shape[dim], out._logical.shape[dim])
    return out


_APPLY = torch.autograd.Function.__dict__["apply"]


def _apply(cls, *args, **kwargs):
    """``Function.apply`` while a caller's forward runs: with a shard-list
    argument, the whole route (the Function's own forward and backward on
    the whole tensors); else the Function as it is."""
    lists = [a for a in _leaves((args, kwargs)) if isinstance(a, ShardList)]
    call = functools.partial(_APPLY.__func__, cls)
    if not lists:
        return call(*args, **kwargs)
    return _whole_op(lists[0]._walk, call, args, kwargs, name=f"{cls.__name__}.apply")


@contextlib.contextmanager
def _dispatching(model: nn.Module, walk: _Walk):
    """For the call: bind the ``forward`` of each outermost child of
    ``model`` that a sharded walk covers to that walk, and
    ``torch.autograd.Function.apply`` to ``_apply``."""
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
    outer = torch.autograd.Function.__dict__["apply"]
    torch.autograd.Function.apply = classmethod(_apply)
    try:
        yield
    finally:
        torch.autograd.Function.apply = outer
        for c, old in bound.values():
            if old is None:
                del c.forward
            else:
                c.forward = old


def _run(walk: _Walk, call: Callable, xs: Shards, masks: Optional[Shards]) -> Shards:
    dim = walk.step.layout.dim
    walk.step.whole_ops.clear()
    args = [_whole(walk, xs, dim)]
    if masks is not None:
        args.append(_whole(walk, masks, dim))
    with _dispatching(walk.step.model, walk):
        out = call(*args)
        if not isinstance(out, torch.Tensor):
            raise TypeError(f"a module's output ({type(out).__name__}) is not a tensor")
        if isinstance(out, ShardList) and out._sdim == dim and out._pad is None:
            return list(out._parts)
        return list(_on_layout(walk, out, "the module's output", args[0]))


def run(step: ShardedStep, xs: Shards, masks: Optional[Shards] = None) -> Shards:
    """The output shards of ``step.model``, a module of the caller's own,
    for the input shards ``xs`` (and, for a module that takes the mask,
    its shards ``masks``): its forward on shard lists, the parameters
    already replicated. ``step.whole_ops`` lists the ops that took the
    whole route."""
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
    splits the axis: raise ``NotImplementedError`` for the first op that
    stays refused (ROADMAP D.4), and return the shard block, the planes a
    shard holds a whole number of where the axis allows, so that every
    stride halves every shard. An axis shorter than the mesh is left to
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
