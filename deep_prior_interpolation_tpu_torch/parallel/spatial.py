"""One patch's volume split along one spatial axis over a mesh of shards
(counterpart of ``parallel/spatial.py``).

In the JAX package this is data placement: GSPMD partitions the solver's
compiled step from the inputs' shardings and writes its collectives. In
PyTorch nothing writes them, so this module runs the MulResUnet over a
list of shards itself, from one process, as JAX's single controller does:

  * a mesh is a list of devices, repeats allowed: ``[cpu] * 8`` stands for
    JAX's 8 virtual CPU devices, ``[cuda:0] * N`` runs N shards on one card;
    ``make_spatial_mesh`` takes the devices that exist where fewer exist
    than asked, as the JAX package does;
  * the shard boundaries lie on multiples of the net's block of the padded
    volume where the axis is a whole number of at least N of them
    (``engine.solver.shard_block``: 2^S planes for S stride-2 steps, 2^(r +
    q) for a phase level r at depth q), so each shard halves exactly at
    every level; elsewhere, as GSPMD shards unevenly, on the largest
    power-of-two block that gives N (single planes at worst). Any axis at
    least as long as the mesh is served: a shard list's bounds are its
    shards' extents, each op maps them (``windows``: a stride-s op's shard
    owns the output planes whose first input plane it holds, and reads the
    window those planes need; an upsample lands on the bounds its consumer
    needs; ``relayout`` moves a list onto other bounds, a concat's crop
    included), and at a level with fewer planes than shards a shard may
    hold none: it is carried through the walk and launches nothing;
  * four collectives, autograd Functions whose sums run on one device in
    shard order, so a sharded step repeats bit for bit: ``_AllReduce`` (N
    tensors in, N copies of their sum out; its backward the same),
    ``_AllMax`` (the volume's max, whose backward splits the cotangent over
    the tied voxels of every shard), ``_Relayout`` (each shard gets any
    interval of the volume's planes from whichever shards hold them, and
    past the volume's ends zeros, copies of the end plane, its mirror or
    -inf: a halo of any width, a crop, another list's bounds; its backward
    adds each plane's gradient into the plane it was copied from) and
    ``_Replicate`` (a parameter to every shard's device;
    its backward sums the shards' gradients, the all-reduce before Adam);
  * ``ShardedStep`` walks the net's own modules and parameters over the
    shards (so parameters, checkpoints and weights files are the plain
    net's): a same-pad conv exchanges a zero halo and convolves unpadded
    along the axis (``conv_halo``, whose weight gradient runs on the wgrad
    kernel); a stride-2 down conv of k = 3 reads the window of its own
    output planes (one plane on the left of an even start, none of an odd
    one); ``Norm`` all-reduces its float32 sums and divides by the
    volume's voxel count; the linear x2 upsample reads the input planes its
    target planes need, one more on each side (copies of the edge plane at
    the volume's ends: the resize's clamp), and crops the output planes
    those alone decide; concats, activations, adds and casts are local;
  * a phase net (``ops/phase_space.py``) is walked piece by piece on its
    phase tensors, whose phase grid splits as the plain grid does: the
    entry conv (plain -> phase: stride 2, kernel k + 1) over its window,
    its output on whole phase blocks where ``space_to_depth`` follows,
    the folded phase -> phase conv through ``conv_halo`` as a plain conv,
    the exit conv (phase -> plain at
    half resolution: kernel 2, padding (1, 0)) over one phase plane on the
    left only, ``upsample_into_phase``'s linear stencil over the resize's
    one-plane clamped halo (one output plane cropped on each side, its
    output on the bounds of the phase tensor it joins), and a
    phase ``Norm`` pools each channel's lanes after its all-reduce; each
    weight transform is made on each shard from its replicated weight, and
    the layout changes (``space_to_depth``, ``depth_to_space``) are local.
    The net's output comes back on its input's bounds. The crop to the
    unpadded volume maps onto the shards (a shard of padding alone keeps
    none) and the loss is the shards' sums all-reduced (one fused-loss
    launch a shard whose crop holds planes). Each Dropout draws one mask at the
    volume's shape of its level, and splits it; remat checkpoints a walked
    block over its list of shards, collectives included, so the recompute
    exchanges the halos again.

The parameters, Adam's moments and the scalar trackers stay on the solver's
device; the canvas, the data and the best and last outputs are split
(``shard_solver_state``); an optimised canvas is one Adam leaf a shard,
each with its moments on its shard's device, gathered whole for the
result and the checkpoint, which a resume splits again. Every random draw
is made whole on the solver's device, from the unsharded step's generator
at its point in the step (the input noise, a virtual canvas, each dropout
mask; the parameter noise perturbs the parameters before they are
replicated), and split, so a sharded solve follows the unsharded one with
the same seed up to the order of its sums. POCS gathers the cropped output to the solver's device
(``SpatialLayout.gather``, whose backward splits the gradient) and
projects the whole volume there, where its weights stay whole.

A sharded solve covers every net ``get_net`` builds: the MulResUnet, plain
or in phase space, 2D and 3D, and the zoo nets (the skip net, the U-Net,
the partial-conv U-Net and the attention MultiRes U-Net, walked in
``parallel/spatial_zoo.py``, with every constructor option, beside the
CBAM U-Net, the ConvGRU ensemble and the library's blocks given to the
solver alone); nearest and linear upsampling, bfloat16 and
float32, both conv formulations (cuDNN and tapmm), the fused and the plain
loss, snapshots, checkpoints, POCS, remat (the MulResUnet's; ``get_net``
gives it to no other net), dropout, parameter noise, data forgetting, a
shaped, a virtual or an optimised canvas. A net given to the solver
(``DIPSolver(model=...)``) of a class no walk covers, a module of the
caller's own, runs its forward over the shards on the walker of
``parallel/spatial_custom.py``, which dispatches the library nets it
calls to their walks and sends every other op by one of four routes (the
walker's vocabulary on the shards; relayouts for slices, flips, rolls,
concatenations and wrap pads along the axis; windows for any conv,
deconv or pool; the whole route, gathered on the first device, for FFTs,
custom autograd Functions and the rest, as GSPMD runs an op it cannot
partition), custom ``Function.apply`` included; ``check_supported`` runs
its meta pass before anything is drawn, which finds the shard block and
refuses only what the JAX package's jitted step refuses too (host reads,
value-dependent shapes, ``out=`` and in-place writes into a plain tensor:
ROADMAP D.4).
"""
from __future__ import annotations

import bisect
import copy
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..models.blocks import Compact, Conv, Dropout, Norm, _bcast, _lanes, upsample
from ..models.mulresunet import MulResUnet, MultiResBlock, ResPath, recomputed
from ..ops import losses as L
from ..ops.conv_vjp import conv_halo, conv_same
from ..ops.fused_loss import fused_loss_sums, metrics_from_sums
from ..ops.noise import get_noise
from ..ops.phase_space import (depth_to_space, entry_kernel, phase_kernel, phase_paddings,
                               space_to_depth, upsample_into_phase)
from .mesh import Mesh, make_mesh

__all__ = ["ShardedStep", "SpatialLayout", "check_supported", "make_spatial_mesh",
           "shard_bounds", "shard_solver_state"]

Bounds = List[Tuple[int, int]]

# data entries shaped as the padded canvas, and as the unpadded volume; the
# POCS weights stay whole, beside the whole-volume projection
_PADDED_KEYS = frozenset({"base_input", "forget_data", "net_mask"})
_CROPPED_KEYS = frozenset({"img", "mask"})
# state entries shaped as the unpadded volume; the rest stays whole
_CARRY_KEYS = frozenset({"out_best", "out_last"})


def make_spatial_mesh(n_devices: int = 0,
                      devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """The devices of a 1-D spatial mesh: the first ``n_devices`` CUDA
    devices (all of them for 0), or the first ``n_devices`` of ``devices``,
    which may repeat one device; where fewer exist than asked, those that
    exist, with a warning naming the cut, as the JAX package takes them
    (``mesh.make_mesh``, which raises where no CUDA device exists)."""
    return make_mesh(n_devices, devices)


def shard_bounds(extent: int, n: int, block: int = 1) -> Bounds:
    """``[start, stop)`` of each of ``n`` shards of an axis of ``extent``
    planes, as even as whole blocks allow (the first shards take one block
    more): blocks of ``block`` planes (the net's) where the axis is a whole
    number of at least ``n`` of them, else of the largest power of two that
    divides the axis into at least ``n`` (single planes at worst), as GSPMD
    shards an axis the mesh does not divide. Raises ``ValueError`` for an
    axis shorter than the mesh, as the JAX package asserts."""
    if extent < n:
        raise ValueError(f"a sharded axis of {extent} planes is shorter than the mesh of {n} "
                         f"shards: pick a longer axis or a smaller mesh")
    if extent % block or extent // block < n:
        block = max(1 << k for k in range(extent.bit_length())
                    if extent % (1 << k) == 0 and extent >> k >= n)
    base, extra = divmod(extent // block, n)
    bounds, a = [], 0
    for i in range(n):
        b = a + (base + (i < extra)) * block
        bounds.append((a, b))
        a = b
    return bounds


def bounds_of(xs: Sequence[torch.Tensor], dim: int) -> Bounds:
    """The planes of the whole that each shard of a list holds along
    ``dim``: its shards' extents laid end to end."""
    out, a = [], 0
    for x in xs:
        out.append((a, a + x.shape[dim]))
        a += x.shape[dim]
    return out


def owned(bounds: Bounds, stride: int, n_out: int) -> Bounds:
    """The output planes of a stride-``stride`` op (``n_out`` of them) that
    each shard of ``bounds`` owns: those whose first input plane it holds
    (output o reads from input plane stride * o on), so shard ``[a, b)``
    owns ``[ceil(a / stride), ceil(b / stride))``, clamped to ``n_out``;
    the last shard also owns the outputs whose first plane lies past the
    volume's end (a window padded by more than its own reach)."""
    out = [(min(-(-a // stride), n_out), min(-(-b // stride), n_out)) for a, b in bounds]
    out[-1] = (out[-1][0], n_out)
    return out


def rounded(bounds: Bounds, m: int) -> Bounds:
    """``bounds`` with each boundary moved to the nearest multiple of ``m``
    (whole blocks of ``m`` planes; a shard may come out empty)."""
    def r(v: int) -> int:
        return m * ((2 * v + m) // (2 * m))
    return [(r(a), r(b)) for a, b in bounds]


class SpatialLayout:
    """Where each shard of a patch lies: the mesh, the sharded spatial axis
    (0 = the first spatial dim), each shard's planes of the padded volume
    (``bounds``) and of the unpadded one (``crops``), the latter centred in
    the former as ``_crop_center`` crops it."""

    def __init__(self, mesh: Sequence[torch.device], axis: int,
                 padded: Sequence[int], spatial: Sequence[int], block: int = 1):
        if not 0 <= axis < len(padded):
            raise ValueError(f"spatial_axis must index a spatial dim (0..{len(padded) - 1}), "
                             f"got {axis}")
        self.mesh = [torch.device(d) for d in mesh]
        self.axis, self.dim = axis, 2 + axis
        self.padded, self.spatial = tuple(padded), tuple(spatial)
        if spatial[axis] < len(self.mesh):
            raise ValueError(f"a sharded axis of {spatial[axis]} planes is shorter than the "
                             f"mesh of {len(self.mesh)} shards: pick a longer axis or a "
                             f"smaller mesh")
        self.bounds = shard_bounds(padded[axis], len(self.mesh), block)
        off, n = (padded[axis] - spatial[axis]) // 2, spatial[axis]
        # a shard of padding planes alone keeps none
        self.crops = [(min(max(a - off, 0), n), min(max(b - off, 0), n)) for a, b in self.bounds]
        # each shard's crop in its own planes of the net's output
        self.local_crops = [(min(max(lo + off - a, 0), b - a), hi - lo)
                            for (a, b), (lo, hi) in zip(self.bounds, self.crops)]

    def split(self, t: torch.Tensor, cropped: bool = False) -> List[torch.Tensor]:
        """An (N, C, *spatial) tensor as shards on their devices, each
        contiguous: at the padded planes, or with ``cropped`` at the
        unpadded ones."""
        return [t.narrow(self.dim, a, b - a).to(d).contiguous()
                for (a, b), d in zip(self.crops if cropped else self.bounds, self.mesh)]

    def views(self, t: torch.Tensor) -> List[torch.Tensor]:
        """A padded-volume tensor's shards as views, moved where a shard
        lives on another device."""
        return [t.narrow(self.dim, a, b - a).to(d) for (a, b), d in zip(self.bounds, self.mesh)]

    def gather(self, ts: Sequence[torch.Tensor], device=None) -> torch.Tensor:
        """The shards as one tensor on ``device`` (the mesh's first device
        by default), differentiable: the gradient goes back split into the
        shards."""
        return _Gather.apply(self.dim, torch.device(device or self.mesh[0]), *ts)

    def crop(self, ts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The net's output shards cropped to the unpadded volume: each
        shard's own planes along the axis, the centre along the others."""
        out = []
        for t, (lo, n) in zip(ts, self.local_crops):
            t = t.narrow(self.dim, lo, n)
            for i, (p, s) in enumerate(zip(self.padded, self.spatial)):
                if i != self.axis:
                    t = t.narrow(2 + i, (p - s) // 2, s)
            out.append(t)
        return out

    def shard(self, data: Dict[str, Any], state: Dict[str, Any]
              ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """``data`` and ``state`` with their volume entries split into
        shards (``shard_solver_state``); every other entry as it was."""
        def place(tree, keys):
            return {k: (self.split(v, cropped=k not in _PADDED_KEYS)
                        if k in keys and v is not None else v) for k, v in tree.items()}
        return place(data, _PADDED_KEYS | _CROPPED_KEYS), place(state, _CARRY_KEYS)


def shard_solver_state(mesh: Sequence[torch.device], spatial_axis: int,
                       data: Dict[str, Any], state: Dict[str, Any], block: int = 1
                       ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Split a solve's volume entries over ``mesh`` along ``spatial_axis``:
    the canvas-shaped data entries (``base_input``, ``forget_data``,
    ``net_mask``) at ``shard_bounds(..., block)`` (``block`` the net's,
    ``engine.solver.shard_block``), the volume-shaped ones (``img``,
    ``mask``) and the state's ``out_best``/``out_last`` at the same
    boundaries cropped to the unpadded volume. Each shard is a contiguous
    tensor on its device;
    the rest (parameters, Adam, trackers, the POCS weights) stays whole.
    Returns ``(data, state)``; raises ``ValueError`` for an axis that is not
    spatial or shorter than the mesh."""
    spatial = tuple(data["img"].shape[2:])
    padded = next((tuple(data[k].shape[2:]) for k in sorted(_PADDED_KEYS)
                   if data.get(k) is not None), spatial)
    return SpatialLayout(mesh, spatial_axis, padded, spatial, block).shard(data, state)


def _sum_in_order(ts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The sum of ``ts`` on ``device``, added in shard order."""
    total = ts[0].to(device)
    for t in ts[1:]:
        total = total + t.to(device)
    return total


class _AllReduce(torch.autograd.Function):
    """N shard tensors in, N copies of their sum out, one on each shard's
    device; the sum runs on the first shard's device in shard order, and so
    does the backward's sum of the N output gradients."""

    @staticmethod
    def forward(ctx, *xs):
        ctx.devices = [x.device for x in xs]
        total = _sum_in_order(xs, xs[0].device)
        return tuple(total.to(d, copy=True) for d in ctx.devices)

    @staticmethod
    def backward(ctx, *gs):
        total = _sum_in_order(gs, ctx.devices[0])
        return tuple(total.to(d, copy=True) for d in ctx.devices)


def all_reduce(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return list(_AllReduce.apply(*xs))


class _AllMax(torch.autograd.Function):
    """N shard tensors in, N copies of the whole volume's max over ``dims``
    (kept) out, one on each shard's device: the shards' maxes compared on
    the first shard's device. The backward sums the N cotangents in shard
    order and splits the sum evenly over every voxel of the whole volume
    that equals the max, counted over all shards: ``torch.amax``'s rule
    (and ``jax.lax.reduce_max``'s), which a max of per-shard maxes would
    break under ties on two shards. A shard without planes has no max."""

    @staticmethod
    def forward(ctx, dims: Tuple[int, ...], *xs):
        live = [x for x in xs if x.numel()]
        top = torch.amax(live[0], dim=dims, keepdim=True)
        for x in live[1:]:
            top = torch.maximum(top, torch.amax(x, dim=dims, keepdim=True).to(top.device))
        ctx.dims = dims
        ctx.save_for_backward(top, *xs)
        return tuple(top.to(x.device, copy=True) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        top, *xs = ctx.saved_tensors
        dev = top.device
        ties = [x == top.to(x.device) for x in xs]
        count = _sum_in_order([t.sum(dim=ctx.dims, keepdim=True) for t in ties], dev)
        scale = _sum_in_order(gs, dev) / count
        return (None, *(scale.to(x.device) * t for x, t in zip(xs, ties)))


def all_max(xs: Sequence[torch.Tensor], dims: Sequence[int]) -> List[torch.Tensor]:
    """The whole volume's max over ``dims`` (kept), one copy a shard."""
    return list(_AllMax.apply(tuple(dims), *xs))


class _Relayout(torch.autograd.Function):
    """Shard i of the output holds the planes ``targets[i] = (s, e)`` of the
    whole along dim 2 + ``axis``, each taken from whichever input shard
    holds it, however far away (an empty interval: no planes); planes past
    the volume's ends follow ``edge`` (``_source``): zeros, copies of the
    end plane (``"replicate"``), the mirror without the end plane
    (``"reflect"``, as ``F.pad`` and ``jnp.pad`` reflect), the planes of
    the other end (``"circular"``, ``F.pad``'s circular and ``jnp.pad``'s
    wrap) or -inf (``"-inf"``, a max pool's padding). Shard i's output lives on input
    shard i's device. The backward adds each copied plane's gradient into
    the plane it was copied from, in a fixed order: into each shard the
    gradient of its own planes in its own output, then the copies in the
    other shards' outputs in shard order, then the edge planes mapped onto
    it in shard order (a run of copies of one plane summed first)."""

    @staticmethod
    def forward(ctx, axis: int, targets: Tuple[Tuple[int, int], ...], edge: str, *xs):
        dim = 2 + axis
        sizes = [x.shape[dim] for x in xs]
        runs = _halo_runs(sizes, targets, edge)
        ctx.dim, ctx.shapes, ctx.runs = dim, [x.shape for x in xs], runs
        outs = []
        for x, rs in zip(xs, runs):
            parts = []
            for pos, count, j, start, step, _ in rs:
                if j is None:
                    shape = list(x.shape)
                    shape[dim] = count
                    parts.append(x.new_full(shape, 0.0 if edge == "zero" else -math.inf))
                    continue
                if step == 0:
                    piece = xs[j].narrow(dim, start, 1).expand(
                        *[count if d == dim else -1 for d in range(x.dim())])
                elif step < 0:
                    piece = xs[j].narrow(dim, start - count + 1, count).flip(dim)
                else:
                    piece = xs[j].narrow(dim, start, count)
                parts.append(piece.to(x.device))
            if not parts:
                outs.append(x.new_empty([0 if d == dim else e for d, e in enumerate(x.shape)]))
            else:
                outs.append(torch.cat(parts, dim) if len(parts) > 1 else parts[0].clone())
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        dim = ctx.dim
        dxs = []
        for i, (g, shape) in enumerate(zip(gs, ctx.shapes)):
            own = [r for r in ctx.runs[i] if r[2] == i and not r[5]]
            if len(own) == 1 and own[0][1] == shape[dim]:   # the whole shard, in one run
                dxs.append(g.narrow(dim, own[0][0], shape[dim]).clone())
                continue
            dx = g.new_zeros(shape)
            for pos, count, _, start, _, _ in own:
                dx.narrow(dim, start, count).copy_(g.narrow(dim, pos, count))
            dxs.append(dx)
        # planes copied into the other shards' outputs, then edge planes
        for edge_pass in (False, True):
            for i, dx in enumerate(dxs):
                for k, (g, rs) in enumerate(zip(gs, ctx.runs)):
                    for pos, count, j, start, step, at_edge in rs:
                        if j != i or at_edge != edge_pass or (k == i and not at_edge):
                            continue
                        piece = g.narrow(dim, pos, count).to(dx.device)
                        if step == 0:
                            dx.narrow(dim, start, 1).add_(piece.sum(dim, keepdim=True))
                        elif step < 0:
                            dx.narrow(dim, start - count + 1, count).add_(piece.flip(dim))
                        else:
                            dx.narrow(dim, start, count).add_(piece)
        return (None, None, None, *dxs)


class _HaloExchange(_Relayout):
    """``_Relayout`` onto each shard's planes with the ``lo`` planes before
    and the ``hi`` after it (a shard without planes gets none)."""

    @staticmethod
    def forward(ctx, axis: int, lo: int, hi: int, edge: str, *xs):
        targets = tuple((a - lo, b + hi) if b > a else (a, a)
                        for a, b in bounds_of(xs, 2 + axis))
        return _Relayout.forward(ctx, axis, targets, edge, *xs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, *_Relayout.backward(ctx, *gs))


def _source(g: int, n: int, edge: str) -> Optional[int]:
    """The plane of an axis of ``n`` planes that plane ``g`` (which may lie
    past either end) copies under ``edge``; None for a constant plane."""
    if 0 <= g < n:
        return g
    if edge == "replicate":
        return 0 if g < 0 else n - 1
    if edge == "circular":
        return g % n
    if edge == "reflect":
        s = -g if g < 0 else 2 * (n - 1) - g
        if not 0 <= s < n:
            raise ValueError(f"a reflect halo reaches plane {g} of an axis of {n} planes: "
                             f"it mirrors at most {n - 1} planes")
        return s
    if edge in ("zero", "-inf"):
        return None
    raise ValueError(f"edge is 'zero', 'replicate', 'reflect', 'circular' or '-inf', got "
                     f"{edge!r}")


def _halo_runs(sizes: Sequence[int], targets: Sequence[Tuple[int, int]],
               edge: str) -> List[list]:
    """Each shard's target planes ``[s, e)`` of the whole as runs ``(pos,
    count, j, start, step, at_edge)``: ``count`` planes from position
    ``pos`` of the shard's output copy shard ``j``'s planes ``start, start
    + step, ...`` (``step`` 1, -1 for a mirror, 0 for copies of one plane;
    ``j`` None for a constant run); ``at_edge`` marks planes past the
    volume's ends. A plane's source shard is the last whose first plane is
    at or before it, so a shard without planes is never one."""
    offsets = [0]
    for s in sizes:
        offsets.append(offsets[-1] + s)
    n = offsets[-1]
    out = []
    for lo_g, hi_g in targets:
        runs: list = []
        for pos, g in enumerate(range(lo_g, hi_g)):
            src, at_edge = _source(g, n, edge), not 0 <= g < n
            j = None if src is None else bisect.bisect_right(offsets, src) - 1
            local = None if src is None else src - offsets[j]
            if runs:
                r = runs[-1]
                if r[2] is None and j is None:
                    r[1] += 1
                    continue
                if r[2] == j and r[5] == at_edge and j is not None:
                    step = local - (r[3] + r[4] * (r[1] - 1))
                    if (r[1] == 1 and step in (1, -1, 0)) or step == r[4]:
                        r[4] = step
                        r[1] += 1
                        continue
            runs.append([pos, 1, j, local, 1, at_edge])
        out.append([tuple(r) for r in runs])
    return out


def relayout(xs: Sequence[torch.Tensor], axis: int, targets: Sequence[Tuple[int, int]],
             edge: str = "zero") -> List[torch.Tensor]:
    """Shard i with the planes ``targets[i]`` of the whole along spatial
    ``axis``, past the volume's ends as ``F.pad`` with ``edge`` would give
    them (``_Relayout``); the shards as they are where each target is its
    own planes."""
    targets = tuple((int(a), int(b)) if b > a else (int(a), int(a)) for a, b in targets)
    if all(t == b or (t[0] == t[1] and b[0] == b[1])
           for t, b in zip(targets, bounds_of(xs, 2 + axis))):
        return list(xs)
    return list(_Relayout.apply(axis, targets, edge, *xs))


def halo_exchange(xs: Sequence[torch.Tensor], axis: int, lo: int, hi: int,
                  edge: str = "zero") -> List[torch.Tensor]:
    """Each shard extended by ``lo`` planes before it and ``hi`` after it
    along spatial ``axis``, as ``F.pad`` of the whole volume with ``edge``
    would give it, at any width (``_HaloExchange``); a shard without
    planes stays without."""
    if not (lo or hi):
        return list(xs)
    return list(_HaloExchange.apply(axis, lo, hi, edge, *xs))


def windows(xs: Sequence[torch.Tensor], axis: int, k: int, stride: int, lo: int,
            edge: str = "zero", n_out: Optional[int] = None,
            out: Optional[Bounds] = None) -> Tuple[List[torch.Tensor], Bounds]:
    """The input window of each shard's output planes under a window op of
    ``k`` planes at ``stride`` along spatial ``axis``, padded by ``lo``
    planes before the volume (output o reads input planes ``[stride * o -
    lo, stride * o - lo + k)``, past the ends as ``edge`` pads): the
    planes ``out`` gives each shard (by default those it owns, ``owned``,
    of ``n_out`` outputs, ceil(n / stride) by default). Returns the
    windows, ``relayout``'s of the shards (the shards themselves where each
    window is its own planes), and the output bounds; the op unpadded along
    the axis on a window gives the shard's output planes, and a shard that
    owns none gets an empty window."""
    dim = 2 + axis
    bounds = bounds_of(xs, dim)
    n = bounds[-1][1]
    if out is None:
        out = owned(bounds, stride, -(-n // stride) if n_out is None else n_out)
    targets = []
    for c, d in out:
        e = stride * (d - 1) - lo + k
        if k < stride:   # the stride's last planes too, where they exist
            e = max(e, min(stride * d - lo, n))
        targets.append((stride * c - lo, e) if d > c else (stride * c, stride * c))
    return relayout(xs, axis, targets, edge), list(out)


def on_shards(fn, xs: Sequence[torch.Tensor], dim: int,
              sizes: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
    """``fn(x, i)`` for each shard ``i`` whose output holds planes along
    ``dim`` (``sizes``; by default its input's extent); for the others,
    which launch nothing, an empty tensor of the outputs' shape on their
    shard's device."""
    sizes = [x.shape[dim] for x in xs] if sizes is None else sizes
    ys = [fn(x, i) if size else None for i, (x, size) in enumerate(zip(xs, sizes))]
    like = next(y for y in ys if y is not None)
    shape = [0 if d == dim else e for d, e in enumerate(like.shape)]
    return [like.new_zeros(shape, device=x.device) if y is None else y
            for x, y in zip(xs, ys)]


def _joined(xs: Sequence[torch.Tensor], dim: int, device: torch.device) -> torch.Tensor:
    """The shards ``xs`` concatenated along ``dim`` on ``device``, in shard
    order: ``_Gather``'s forward and ``_Split``'s backward."""
    return torch.cat([x.to(device) for x in xs], dim)


class _Gather(torch.autograd.Function):
    """N shards in, their concatenation along ``dim`` on ``device`` out; the
    backward splits the gradient into the shards' pieces, each moved to its
    shard's device."""

    @staticmethod
    def forward(ctx, dim: int, device: torch.device, *xs):
        ctx.dim, ctx.devices = dim, [x.device for x in xs]
        ctx.sizes = [x.shape[dim] for x in xs]
        return _joined(xs, dim, device)

    @staticmethod
    def backward(ctx, g):
        return (None, None, *(p.to(d) for p, d in zip(g.split(ctx.sizes, ctx.dim),
                                                      ctx.devices)))


class _Split(torch.autograd.Function):
    """A whole tensor in, its planes ``bounds[i]`` along ``dim`` out as shard
    i, a contiguous copy on ``devices[i]`` (``SpatialLayout.split``'s
    narrow and move); the backward gathers the shards' gradients on the
    whole's device in shard order, as ``_Gather``'s forward does, so the
    two are exact transposes."""

    @staticmethod
    def forward(ctx, dim: int, bounds: Tuple[Tuple[int, int], ...],
                devices: Tuple[torch.device, ...], t):
        ctx.dim, ctx.device = dim, t.device
        return tuple(t.narrow(dim, a, b - a).to(d, copy=True,
                                                memory_format=torch.contiguous_format)
                     for (a, b), d in zip(bounds, devices))

    @staticmethod
    def backward(ctx, *gs):
        return None, None, None, _joined(gs, ctx.dim, ctx.device)


def split(t: torch.Tensor, dim: int, bounds: Bounds,
          devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``t`` as shards: shard i its planes ``bounds[i]`` along ``dim`` on
    ``devices[i]``, differentiable (``_Split``: its backward gathers)."""
    return list(_Split.apply(dim, tuple(tuple(b) for b in bounds), tuple(devices), t))


class _Replicate(torch.autograd.Function):
    """P parameters in, a copy of each on each of N devices out (shard-major:
    shard i's copy of parameter j at i * P + j; on the parameter's own
    device the copy shares its storage). The backward sums each
    parameter's N gradients on its device in shard order."""

    @staticmethod
    def forward(ctx, devices: Tuple[torch.device, ...], *params):
        ctx.n, ctx.devices = len(devices), [p.device for p in params]
        return tuple(p.detach() if d == p.device else p.detach().to(d)
                     for d in devices for p in params)

    @staticmethod
    def backward(ctx, *gs):
        n_p = len(ctx.devices)
        return (None, *(_sum_in_order(gs[j::n_p], ctx.devices[j]) for j in range(n_p)))


def check_supported(model: torch.nn.Module, input_shape: Optional[Sequence[int]] = None,
                    n: int = 1, axis: int = 0, takes_mask: bool = False,
                    dtype: torch.dtype = torch.float32) -> Optional[int]:
    """None for a net of a class a sharded walk covers (every net
    ``get_net`` builds, every library net and block with any of its
    constructor options, and a subclass that keeps its base's forward).
    For any other module (a module of the caller's own) with the canvas's
    ``input_shape``, the walker's meta pass (``spatial_custom.meta_pass``)
    over ``n`` meta shards along spatial ``axis``: it raises
    ``NotImplementedError`` naming the op and ROADMAP D.4 for what the JAX
    package's jitted step refuses too (a host read, a value-dependent
    shape, ``out=`` or an in-place write into a plain tensor), before
    anything is drawn, and returns the shard block it found."""
    from .spatial_zoo import uncovered
    if uncovered(model) is None or input_shape is None:
        return None
    from .spatial_custom import meta_pass
    return meta_pass(model, input_shape, n, axis, takes_mask, dtype)


def _each(fn, xs: List[torch.Tensor], times: int = 1) -> List[torch.Tensor]:
    """``fn`` applied ``times`` times to each shard (a local layout change)."""
    for _ in range(times):
        xs = [fn(x) for x in xs]
    return xs


class ShardedStep:
    """The sharded pieces of the solver's step for ``model`` over
    ``layout``: the net input, the net's forward walked over the shards
    (mirroring ``MulResUnet.forward``, ``MultiResBlock`` and ``ResPath``,
    plain or in phase space; a zoo net's in ``spatial_zoo.walk``) and the
    loss terms."""

    def __init__(self, model: torch.nn.Module, layout: SpatialLayout):
        self.model, self.layout = model, layout
        self._params = list(model.parameters())
        self._reps: Dict[int, List[torch.Tensor]] = {}
        # the ops of a caller's module that its last forward ran whole
        # (``spatial_custom.WholeOp``); empty for a library net
        self.whole_ops: List[Any] = []

    # -- the step -----------------------------------------------------------

    def net_input(self, it: int, st, data, s, gens, regenerate) -> List[torch.Tensor]:
        """The canvas shards (the optimised canvas's shard leaves under
        input optimisation) plus iteration ``it``'s perturbations, as
        ``DIPSolver._net_input`` makes them: the noise (and a virtual
        canvas, ``regenerate``) drawn whole on the generator's device and
        split, the forgetting term from the split forgetting data. Each
        shard's sum is the unsharded one's, element for element."""
        if s.opt_input:
            base = st["flat"].canvas
        elif s.virtual_input:
            base = self.layout.views(regenerate())
        else:
            base = data["base_input"]
        extra = None
        if s.reg_noise_std > 0:
            extra = self.layout.views(s.reg_noise_std * get_noise(
                gens["noise"], s.input_shape, "n", base[0].dtype, gens["noise"].device))
        if s.forget_factor > 0:
            w = data["forget_w"][min(it, s.forget_factor)]
            fe = [w.to(f.device) * f for f in data["forget_data"]]
            extra = fe if extra is None else [e + f for e, f in zip(extra, fe)]
        return list(base) if extra is None else [b + e for b, e in zip(base, extra)]

    def loss_terms(self, outs: List[torch.Tensor], data, s, out_dtype: torch.dtype,
                   device: torch.device):
        """The cropped output shards, the loss on ``device`` and the step's
        metrics (snr, pcorr), from the shards' sums all-reduced."""
        if outs[0].dtype != out_dtype:
            raise TypeError(f"the net's output is {outs[0].dtype}, the tracked best output "
                            f"{out_dtype}")
        outs = self.layout.crop(outs)
        imgs, masks = data["img"], data["mask"]
        if s.fused_loss:   # a shard whose crop holds no planes has no sums
            sums = all_reduce([fused_loss_sums(o, t, m) for o, t, m in zip(outs, imgs, masks)
                               if o.numel()])
            main, mets = metrics_from_sums(sums[0], float(sum(o.numel() for o in outs)), s.loss)
            ys = {"snr": mets["snr"].detach(), "pcorr": mets["pcorr"].detach()}
        else:
            def total(parts):
                return _sum_in_order(parts, self.layout.mesh[0])
            main = L.masked_fit(outs, imgs, masks, s.loss, total)
            with torch.no_grad():
                ys = L.snr_pcorr([o.detach().float() for o in outs], imgs, total)
        ys = {k: v.to(device) for k, v in ys.items()}
        return outs, main.to(device), ys

    # -- the net ------------------------------------------------------------

    def __call__(self, xs: Sequence[torch.Tensor],
                 masks: Optional[Sequence[torch.Tensor]] = None) -> List[torch.Tensor]:
        """The net's output shards for the input shards ``xs`` (and, for a
        net that takes the mask, its shards ``masks``). Each call
        replicates the parameters once (their gradients come back summed)
        and the buffers (a copy a device)."""
        reps = _Replicate.apply(tuple(self.layout.mesh), *self._params)
        n_p = len(self._params)
        self._reps = {id(p): list(reps[j::n_p]) for j, p in enumerate(self._params)}
        for b in self.model.buffers():
            self._reps[id(b)] = [b if b.device == d else b.to(d) for d in self.layout.mesh]
        try:
            return self.walk(list(xs), None if masks is None else list(masks))
        finally:
            self._reps = {}

    def walk(self, xs: List[torch.Tensor],
             masks: Optional[List[torch.Tensor]] = None) -> List[torch.Tensor]:
        """The net's output shards, its parameters replicated: the
        MulResUnet's walk, a zoo net's or library block's
        (``spatial_zoo.walk``), or for a module of the caller's own the
        walker's run of its forward (``spatial_custom.run``)."""
        from .spatial_zoo import covered_class, walk
        m, cls = self.model, covered_class(self.model)
        if cls is None:
            from .spatial_custom import run
            ys = run(self, xs, masks)
        elif cls is not MulResUnet:
            ys = walk(self, xs, masks)
        else:
            ys = self._mulresunet(xs)
        # an output of the input's planes on the input's bounds (a phase
        # net's blocks may have moved them)
        dim = self.layout.dim
        if bounds_of(ys, dim)[-1][1] != bounds_of(xs, dim)[-1][1]:
            return ys
        return relayout(ys, self.layout.axis, bounds_of(xs, dim))

    def _mulresunet(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        m = self.model
        spatial = list(xs[0].shape[2:])
        spatial[self.layout.axis] = sum(x.shape[self.layout.dim] for x in xs)
        m.check_phase_dims(spatial)
        in_dtype = xs[0].dtype
        if m.dtype is not None:
            xs = [x.to(m.dtype) for x in xs]
        x = self._block(m.get_submodule(m.block0), 0, xs)
        x = self._level(1, x)
        x = _each(depth_to_space, self._conv(m.get_submodule(m.head), x), m.pdepth(0))
        return [m.last_act(t).to(in_dtype) for t in x]

    def child(self, model: torch.nn.Module) -> "ShardedStep":
        """The step of a library net met inside a module of the caller's
        own: the same layout and replicated parameters."""
        sub = copy.copy(self)
        sub.model = model
        return sub

    def _rep(self, p: torch.Tensor) -> List[torch.Tensor]:
        return self._reps[id(p)]

    def _block(self, m, level: int, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """A walked MultiResBlock or ResPath of ``level``; where remat covers
        the level, checkpointed over its list of shards, so the backward
        walks it again (halo exchanges and all-reduces included) with this
        call's replicated parameters and dropout masks."""
        walk = self._respath if isinstance(m, ResPath) else self._multires
        net = self.model
        if not net.remats(level) or Compact.building:   # a meta pass recomputes nothing
            return walk(m, xs)
        reps = self._reps

        def run(*shards):
            outer, self._reps = self._reps, reps
            try:
                return walk(m, list(shards))
            finally:
                self._reps = outer
        return recomputed(run, xs, net.drop.generator if net.drop.rate > 0 else None)

    def _drop(self, m: Dropout, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """``blocks.Dropout`` over the shards: one keep mask at the volume's
        shape at this level, drawn on the generator's device where the
        unsharded step draws it, split as the shards lie; in a meta pass
        (``Compact.building``) none."""
        if m.rate <= 0.0 or m.rate >= 1.0 or Compact.building:
            return [m(x) for x in xs]
        dim = self.layout.dim
        shape = list(xs[0].shape)
        shape[dim] = sum(x.shape[dim] for x in xs)
        kept = m.draw(shape).split([x.shape[dim] for x in xs], dim)
        return [m.keep(x, k.to(x.device)) for x, k in zip(xs, kept)]

    def _conv(self, m: Conv, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """``blocks.Conv`` on the shards, with ``ops/phase_space.py``'s convs
        of a phase conv, each weight transform made on each shard from its
        replicated weight: a stride-1 conv (the plain one, or a phase ->
        phase conv with the folded kernel) over a zero halo of (k - 1) / 2
        planes, unpadded along the axis (``conv_halo``); a stride-2 down
        conv (k odd, p = (k - 1) / 2) over the window of the output planes
        each shard owns (``windows``); the phase entry (stride 2, kernel k +
        1) over its window, its output planes on whole blocks of the phase
        depth where ``space_to_depth`` follows; the phase exit (kernel 2,
        padding (1, 0)) over one plane on the left."""
        dt = m.dtype if m.dtype is not None else xs[0].dtype
        k = m.kernel_size
        xs = [x.to(dt) for x in xs]
        ws = [w.to(dt) for w in self._rep(m.kernel)]
        if m.phase_out and not m.phase_in:      # plain -> phase
            p, dim = (k - 1) // 2, self.layout.dim
            out = None
            if m.phase_depth > 1:   # whole phase blocks for space_to_depth
                n = bounds_of(xs, dim)[-1][1]
                out = rounded(owned(bounds_of(xs, dim), 2, n // 2), 2 ** (m.phase_depth - 1))
            ys = _each(space_to_depth, self._halo_conv(
                xs, [entry_kernel(w) for w in ws], 2, (p, p), out), m.phase_depth - 1)
        elif m.phase_in and not m.phase_out:    # phase -> plain at half resolution
            pads = phase_paddings(k, 2)
            ys = self._halo_conv(_each(depth_to_space, xs, m.phase_depth - 1),
                                 [phase_kernel(w, 2) for w in ws], 1, pads)
        elif m.pad == "reflection" and k > 1:
            ys = self._reflect_conv(xs, ws, m.stride, (k - 1) // 2)
        elif m.stride == 1:
            for _ in range(m.phase_depth if m.phase_in else 0):   # phase -> phase
                ws = [phase_kernel(w, 1) for w in ws]
            p, ax = (ws[0].shape[2] - 1) // 2, self.layout.axis
            if p:
                ys = on_shards(lambda x, i: conv_halo(x, ws[i], ax, p),
                               halo_exchange(xs, ax, p, p, "zero"), self.layout.dim,
                               [x.shape[self.layout.dim] for x in xs])
            else:
                ys = on_shards(lambda x, i: conv_same(x, ws[i], 1, 0), xs, self.layout.dim)
        else:   # a stride-2 down conv, k odd
            p = (k - 1) // 2
            ys = self._halo_conv(xs, ws, 2, (p, p))
        if m.bias is not None:
            lanes = 2 ** ((ys[0].ndim - 2) * m.phase_depth) if m.phase_out else 1
            ys = [y + _bcast(_lanes(b.to(dt), lanes), y.ndim)
                  for y, b in zip(ys, self._rep(m.bias))]
        return ys

    def _reflect_conv(self, xs: List[torch.Tensor], ws: List[torch.Tensor], stride: int,
                      p: int) -> List[torch.Tensor]:
        """A reflection-padded conv (``Conv(pad="reflection")``: ``F.pad``
        reflect by p, then unpadded) on the shards: each shard's window
        along the axis over a reflect edge (``windows``), ``F.pad`` reflect
        along the others, unpadded; like the plain net's, its weight
        gradient never takes the wgrad kernel, whose gate admits same-padded
        convs only."""
        ax, dim = self.layout.axis, self.layout.dim
        k = ws[0].shape[2 + ax]
        n = bounds_of(xs, dim)[-1][1]
        xs, out = windows(xs, ax, k, stride, p, "reflect", (n + 2 * p - k) // stride + 1)
        nd = xs[0].dim() - 2
        spec = [p] * (2 * nd)
        spec[2 * (nd - 1 - ax)] = spec[2 * (nd - 1 - ax) + 1] = 0
        return on_shards(lambda x, i: conv_same(F.pad(x, spec, mode="reflect"), ws[i], stride, 0),
                         xs, dim, [d - c for c, d in out])

    def _halo_conv(self, xs: List[torch.Tensor], ws: List[torch.Tensor], stride: int,
                   pad: Tuple[int, int], out: Optional[Bounds] = None) -> List[torch.Tensor]:
        """``conv_same`` of each shard's window (``windows``: the output
        planes it owns, or ``out``'s, over a zero edge) at ``stride``,
        unpadded along the axis, ``pad`` (lo, hi) on the other axes."""
        ax, dim = self.layout.axis, self.layout.dim
        k = ws[0].shape[2 + ax]
        n = bounds_of(xs, dim)[-1][1]
        xs, out = windows(xs, ax, k, stride, pad[0], "zero",
                          (n + pad[0] + pad[1] - k) // stride + 1, out)
        pads = [pad] * (xs[0].dim() - 2)
        pads[ax] = (0, 0)
        return on_shards(lambda x, i: conv_same(x, ws[i], stride, pads), xs, dim,
                         [d - c for c, d in out])

    def _norm(self, m: Norm, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """``blocks.Norm`` of the whole volume: the shards' float32 sums
        (float64 for float64 shards) all-reduced, over the volume's voxel
        count; of a phase tensor, each channel's ``m.phase`` lanes pooled
        after the all-reduce."""
        axes = [0] + list(range(2, xs[0].ndim))
        parts = []
        for x in xs:
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            parts.append(torch.stack([torch.sum(xf, dim=axes), torch.sum(xf * xf, dim=axes)]))
        count = float(sum(x.numel() // x.shape[1] for x in xs)) * m.phase
        outs = []
        for x, s, scale, bias in zip(xs, all_reduce(parts), self._rep(m.scale),
                                     self._rep(m.bias)):
            if m.phase > 1:
                s = s.view(2, -1, m.phase).sum(-1)
            mean = s[0] / count
            var = torch.clamp(s[1] / count - mean * mean, min=0.0)
            g = scale * torch.rsqrt(var + m.eps)
            b = bias - mean * g
            if m.phase > 1:
                g, b = _lanes(g, m.phase), _lanes(b, m.phase)
            outs.append(x * _bcast(g.to(x.dtype), x.ndim) + _bcast(b.to(x.dtype), x.ndim))
        return outs

    def _cna(self, m, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        return [m.act(y) for y in self._norm(m.Norm_0, self._conv(m.Conv_0, xs))]

    def _upsample(self, xs: List[torch.Tensor], mode: Optional[str] = None,
                  into_phase: bool = False, out: Optional[Bounds] = None
                  ) -> List[torch.Tensor]:
        """The x2 upsample of ``mode`` (the model's ``upsample_mode`` by
        default), or with ``into_phase`` ``upsample_into_phase`` (whose
        output grid is its input's), its output on the bounds ``out`` (the
        input's doubled, or its own with ``into_phase``, by default): each
        shard reads the input planes its output planes need ('nearest'),
        and for a linear mode one plane more on each side (a copy of the
        edge plane at the volume's ends, as the resize clamps there), and
        its output is cropped to its own planes: those cropped away at
        either end are the ones its outer planes alone decide."""
        mode = self.model.upsample_mode if mode is None else mode
        ax, dim = self.layout.axis, self.layout.dim
        f = 1 if into_phase else 2
        if out is None:
            out = [(f * a, f * b) for a, b in bounds_of(xs, dim)]
        halo = 0 if mode == "nearest" else 1
        starts = [c // f - halo for c, _ in out]
        xs = relayout(xs, ax, [(a, -(-d // f) + halo) if d > c else (a, a)
                               for a, (c, d) in zip(starts, out)], "replicate")

        def up(x: torch.Tensor, i: int) -> torch.Tensor:
            if into_phase:
                y = upsample_into_phase(x, "nearest" if mode == "nearest" else "linear")
            else:
                y = upsample(x, 2, mode)
            c, d = out[i]
            lo = c - f * starts[i]
            return y if (lo, d - c) == (0, y.shape[dim]) else y.narrow(dim, lo, d - c)
        return on_shards(up, xs, dim, [d - c for c, d in out])

    def _multires(self, m: MultiResBlock, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        out1 = self._cna(m.ConvNormAct_0, xs)
        out2 = self._cna(m.ConvNormAct_1, out1)
        out3 = self._cna(m.ConvNormAct_2, out2)
        out = [torch.cat(t, dim=1) for t in zip(out1, out2, out3)]
        if m.extra_norm:
            out = self._norm(m.Norm_0, out)
        out = self._drop(m.drop, out)
        out = [m.act(a + b) for a, b in zip(self._cna(m.ConvNormAct_3, xs), out)]
        if m.extra_norm:
            out = self._norm(m.Norm_1, out)
        return self._drop(m.drop, out)

    def _respath(self, m: ResPath, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        for i in range(m.length):
            a = self._cna(getattr(m, f"ConvNormAct_{2 * i}"), xs)
            b = self._cna(getattr(m, f"ConvNormAct_{2 * i + 1}"), xs)
            y, norm = [m.act(u + v) for u, v in zip(a, b)], getattr(m, f"Norm_{i}")
            xs = (self._norm(norm, self._drop(m.drop, y)) if m.norm_last
                  else self._drop(m.drop, self._norm(norm, y)))
        return xs

    def _level(self, i: int, hs: List[torch.Tensor]) -> List[torch.Tensor]:
        m = self.model
        names = m.levels[i]
        s = self._block(m.get_submodule(names["path"]), i, hs) if names["path"] else None
        d = self._conv(m.get_submodule(names["down"]), hs)
        if names["norm"]:
            d = self._norm(m.get_submodule(names["norm"]), d)
        d = self._block(m.get_submodule(names["enc"]), i,
                        self._drop(m.drop, [m.act(t) for t in d]))
        if i < len(m.filters) - 1:
            d = self._level(i + 1, d)
        d = _each(depth_to_space, d, m.pdepth(i))
        # the x2 upsample lands on the bounds of the level's input
        hb = bounds_of(hs, self.layout.dim)
        if m.phased(i - 1):   # in phase layout: its depth-1 grid is d's
            q = m.pdepth(i - 1) - 1
            d = _each(space_to_depth, self._upsample(
                d, into_phase=True, out=[(a << q, b << q) for a, b in hb]), q)
        else:
            d = self._upsample(d, out=hb)
        y = [torch.cat([a, b], dim=1) for a, b in zip(s, d)] if s is not None else d
        return self._block(m.get_submodule(names["dec"]), i, y)
