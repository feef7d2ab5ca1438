"""One patch's volume split along one spatial axis over a mesh of shards
(counterpart of ``parallel/spatial.py``).

In the JAX package this is data placement: GSPMD partitions the solver's
compiled step from the inputs' shardings and writes its collectives. In
PyTorch nothing writes them, so this module runs the MulResUnet over a
list of shards itself, from one process, as JAX's single controller does:

  * a mesh is a list of devices, repeats allowed: ``[cpu] * 8`` stands for
    JAX's 8 virtual CPU devices, ``[cuda:0] * N`` runs N shards on one card;
  * the shard boundaries lie on multiples of 2^L planes of the padded
    volume (L downsamplings), so each shard halves exactly at every level
    and every halo is (k - 1) / 2 planes of its own level;
  * three collectives, autograd Functions whose sums run on one device in
    shard order, so a sharded step repeats bit for bit: ``_AllReduce`` (N
    tensors in, N copies of their sum out; its backward the same),
    ``_HaloExchange`` (each shard gets its neighbours' edge planes, zeros or
    a copy of its own edge plane at the volume's ends; its backward adds
    each halo plane's gradient into the plane it was copied from) and
    ``_Replicate`` (a parameter to every shard's device; its backward sums
    the shards' gradients, the all-reduce before Adam);
  * ``ShardedStep`` walks the net's own modules and parameters over the
    shards (so parameters, checkpoints and weights files are the plain
    net's): a same-pad conv exchanges a zero halo and convolves unpadded
    along the axis (``conv_halo``, whose weight gradient runs on the wgrad
    kernel); the stride-2 down conv takes a left halo of one plane (each
    shard starts on an even plane); ``Norm`` all-reduces its float32 sums
    and divides by the volume's voxel count; the linear x2 upsample takes a
    one-plane halo that copies the edge plane at the volume's ends (the
    resize's clamp) and crops two output planes on each side; concats,
    activations, adds and casts are local. The crop to the unpadded volume
    maps onto the shards (only the first and last lose planes) and the
    loss is the shards' sums all-reduced (one fused-loss launch a shard).
    Each Dropout draws one mask at the volume's shape of its level, and
    splits it; remat checkpoints a walked block over its list of shards,
    collectives included, so the recompute exchanges the halos again.

The parameters, Adam's moments and the scalar trackers stay on the solver's
device; the canvas, the data and the best and last outputs are split
(``shard_solver_state``). Every random draw is made whole on the solver's
device, from the unsharded step's generator at its point in the step (the
input noise, a virtual canvas, each dropout mask; the parameter noise
perturbs the parameters before they are replicated), and split, so a
sharded solve follows the unsharded one with the same seed up to the
order of its sums. POCS gathers the cropped output to the solver's device
(``SpatialLayout.gather``, whose backward splits the gradient) and
projects the whole volume there, where its weights stay whole.

A sharded solve covers the plain MulResUnet, 2D and 3D, nearest and linear
upsampling, bfloat16 and float32, the fused and the plain loss, snapshots,
checkpoints, POCS, remat, dropout, parameter noise, data forgetting, a
shaped or a virtual canvas; ``check_supported`` refuses the rest (ROADMAP
A.13c: input optimisation, phase space, tapmm and the zoo nets).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..config import Config
from ..models.blocks import Conv, Dropout, Norm, _bcast, upsample
from ..models.mulresunet import MulResUnet, MultiResBlock, ResPath, recomputed
from ..ops import losses as L
from ..ops.conv_vjp import conv_halo, conv_same
from ..ops.fused_loss import fused_loss_sums, metrics_from_sums
from ..ops.noise import get_noise
from .mesh import Mesh, make_mesh

__all__ = ["ShardedStep", "SpatialLayout", "check_supported", "make_spatial_mesh",
           "shard_bounds", "shard_solver_state"]

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
    which may repeat one device. Raises where fewer exist than asked (the
    JAX package takes as many as there are)."""
    return make_mesh(n_devices, devices)


def shard_bounds(extent: int, n: int, block: int) -> List[Tuple[int, int]]:
    """``[start, stop)`` of each of ``n`` shards of an axis of ``extent``
    planes, each a whole number of ``block``-plane blocks, as even as the
    blocks allow (the first shards take one block more)."""
    if extent % block:
        raise ValueError(f"a sharded axis of {extent} planes is not a whole number of "
                         f"{block}-plane blocks (the net's 2^levels)")
    blocks = extent // block
    if blocks < n:
        raise ValueError(f"a sharded axis of {extent} planes holds {blocks} blocks of {block} "
                         f"planes: a mesh of at most {blocks} shards fits it, not {n}")
    base, extra = divmod(blocks, n)
    bounds, a = [], 0
    for i in range(n):
        b = a + (base + (i < extra)) * block
        bounds.append((a, b))
        a = b
    return bounds


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
        self.bounds = shard_bounds(padded[axis], len(self.mesh), block)
        off, n = (padded[axis] - spatial[axis]) // 2, spatial[axis]
        self.crops = [(min(max(a - off, 0), n), min(max(b - off, 0), n)) for a, b in self.bounds]
        if any(hi == lo for lo, hi in self.crops):
            raise ValueError(f"a shard of {self.bounds} holds padding planes alone (the "
                             f"volume's {n} planes start at {off}): use fewer shards")
        # each shard's crop in its own planes of the net's output
        self.local_crops = [(lo + off - a, hi - lo) for (a, _), (lo, hi)
                            in zip(self.bounds, self.crops)]

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
    ``net_mask``) at boundaries on multiples of ``block`` planes (2^L for a
    net of L downsamplings), the volume-shaped ones (``img``, ``mask``) and
    the state's ``out_best``/``out_last`` at the same boundaries cropped to
    the unpadded volume. Each shard is a contiguous tensor on its device;
    the rest (parameters, Adam, trackers, the POCS weights) stays whole.
    Returns ``(data, state)``; raises ``ValueError`` for an axis that is not
    spatial or too short for the mesh."""
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


class _HaloExchange(torch.autograd.Function):
    """Each shard with ``lo`` planes of its left neighbour before it and
    ``hi`` planes of its right one after it, along dim 2 + ``axis``; at the
    volume's two ends zeros (``edge="zero"``) or copies of the shard's own
    edge plane (``edge="replicate"``). The backward adds each halo plane's
    gradient into the plane it was copied from, shard by shard in order."""

    @staticmethod
    def forward(ctx, axis: int, lo: int, hi: int, edge: str, *xs):
        dim = 2 + axis
        sizes = [x.shape[dim] for x in xs]
        if min(sizes) < max(lo, hi):
            raise ValueError(f"a halo of {max(lo, hi)} planes needs shards of as many, got "
                             f"{sizes}")
        ctx.axis, ctx.lo, ctx.hi, ctx.edge, ctx.sizes = axis, lo, hi, edge, sizes
        ctx.devices = [x.device for x in xs]
        n, outs = len(xs), []
        for i, x in enumerate(xs):
            parts = []
            if lo:
                if i > 0:
                    parts.append(xs[i - 1].narrow(dim, sizes[i - 1] - lo, lo).to(x.device))
                else:
                    parts.append(_edge(x, dim, 0, lo, edge))
            parts.append(x)
            if hi:
                if i < n - 1:
                    parts.append(xs[i + 1].narrow(dim, 0, hi).to(x.device))
                else:
                    parts.append(_edge(x, dim, sizes[i] - 1, hi, edge))
            outs.append(torch.cat(parts, dim))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        dim, lo, hi, sizes = 2 + ctx.axis, ctx.lo, ctx.hi, ctx.sizes
        n, dxs = len(gs), []
        for i, g in enumerate(gs):
            dx = g.narrow(dim, lo, sizes[i]).clone()
            if hi and i > 0:      # the left neighbour's right halo: my first planes
                dx.narrow(dim, 0, hi).add_(
                    gs[i - 1].narrow(dim, lo + sizes[i - 1], hi).to(dx.device))
            if lo and i < n - 1:  # the right neighbour's left halo: my last planes
                dx.narrow(dim, sizes[i] - lo, lo).add_(gs[i + 1].narrow(dim, 0, lo).to(dx.device))
            if ctx.edge == "replicate":
                if lo and i == 0:
                    dx.narrow(dim, 0, 1).add_(g.narrow(dim, 0, lo).sum(dim, keepdim=True))
                if hi and i == n - 1:
                    dx.narrow(dim, sizes[i] - 1, 1).add_(
                        g.narrow(dim, lo + sizes[i], hi).sum(dim, keepdim=True))
            dxs.append(dx)
        return (None, None, None, None, *dxs)


def _edge(x: torch.Tensor, dim: int, plane: int, count: int, edge: str) -> torch.Tensor:
    """``count`` planes past the volume's end: zeros, or copies of ``plane``."""
    if edge == "zero":
        shape = list(x.shape)
        shape[dim] = count
        return x.new_zeros(shape)
    if edge == "replicate":
        return x.narrow(dim, plane, 1).expand(
            *[count if d == dim else -1 for d in range(x.dim())])
    raise ValueError(f"edge is 'zero' or 'replicate', got {edge!r}")


def halo_exchange(xs: Sequence[torch.Tensor], axis: int, lo: int, hi: int,
                  edge: str = "zero") -> List[torch.Tensor]:
    return list(_HaloExchange.apply(axis, lo, hi, edge, *xs))


class _Gather(torch.autograd.Function):
    """N shards in, their concatenation along ``dim`` on ``device`` out; the
    backward splits the gradient into the shards' pieces, each moved to its
    shard's device."""

    @staticmethod
    def forward(ctx, dim: int, device: torch.device, *xs):
        ctx.dim, ctx.devices = dim, [x.device for x in xs]
        ctx.sizes = [x.shape[dim] for x in xs]
        return torch.cat([x.to(device) for x in xs], dim)

    @staticmethod
    def backward(ctx, g):
        return (None, None, *(p.to(d) for p, d in zip(g.split(ctx.sizes, ctx.dim),
                                                      ctx.devices)))


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


def check_supported(cfg: Config) -> None:
    """Raise ``NotImplementedError`` naming ROADMAP A.13c for what a sharded
    solve does not cover yet, in that item's order."""
    refused = [
        ("input" in cfg.opt_over.split(","), "opt_over with 'input' (the canvas would be "
                                             "a sharded parameter)"),
        (cfg.phase_space and cfg.phase_levels != 0, "phase space"),
        (cfg.vmap_conv_mode == "tapmm", "conv_impl('tapmm')"),
        (cfg.net not in ("multiunet", "load"), f"--net {cfg.net}"),
    ]
    for refuse, what in refused:
        if refuse:
            raise NotImplementedError(f"a spatially sharded solve with {what}: ROADMAP A.13c")


class ShardedStep:
    """The sharded pieces of the solver's step for ``model`` (a plain
    MulResUnet) over ``layout``: the net input, the net's forward walked
    over the shards (mirroring ``MulResUnet.forward``, ``MultiResBlock`` and
    ``ResPath``) and the loss terms."""

    def __init__(self, model: MulResUnet, layout: SpatialLayout):
        self.model, self.layout = model, layout
        self._params = list(model.parameters())
        self._reps: Dict[int, List[torch.Tensor]] = {}

    # -- the step -----------------------------------------------------------

    def net_input(self, it: int, data, s, gens, regenerate) -> List[torch.Tensor]:
        """The canvas shards plus iteration ``it``'s perturbations, as
        ``DIPSolver._net_input`` makes them: the noise (and a virtual
        canvas, ``regenerate``) drawn whole on the generator's device and
        split, the forgetting term from the split forgetting data. Each
        shard's sum is the unsharded one's, element for element."""
        base = self.layout.views(regenerate()) if s.virtual_input else data["base_input"]
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
        if s.fused_loss:
            sums = all_reduce([fused_loss_sums(o, t, m) for o, t, m in zip(outs, imgs, masks)])
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

    def __call__(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The net's output shards for the input shards ``xs``. Each call
        replicates the parameters once; their gradients come back summed."""
        m = self.model
        reps = _Replicate.apply(tuple(self.layout.mesh), *self._params)
        n_p = len(self._params)
        self._reps = {id(p): list(reps[j::n_p]) for j, p in enumerate(self._params)}
        try:
            in_dtype = xs[0].dtype
            if m.dtype is not None:
                xs = [x.to(m.dtype) for x in xs]
            x = self._block(m.get_submodule(m.block0), 0, xs)
            x = self._level(1, x)
            x = self._conv(m.get_submodule(m.head), x)
            return [m.last_act(t).to(in_dtype) for t in x]
        finally:
            self._reps = {}

    def _rep(self, p: torch.Tensor) -> List[torch.Tensor]:
        return self._reps[id(p)]

    def _block(self, m, level: int, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """A walked MultiResBlock or ResPath of ``level``; where remat covers
        the level, checkpointed over its list of shards, so the backward
        walks it again (halo exchanges and all-reduces included) with this
        call's replicated parameters and dropout masks."""
        walk = self._respath if isinstance(m, ResPath) else self._multires
        net = self.model
        if not net.remats(level):
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
        unsharded step draws it, split as the shards lie."""
        if m.rate <= 0.0 or m.rate >= 1.0:
            return [m(x) for x in xs]
        dim = self.layout.dim
        shape = list(xs[0].shape)
        shape[dim] = sum(x.shape[dim] for x in xs)
        kept = m.draw(shape).split([x.shape[dim] for x in xs], dim)
        return [m.keep(x, k.to(x.device)) for x, k in zip(xs, kept)]

    def _conv(self, m: Conv, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """``blocks.Conv`` on the shards: a same-pad conv over a zero halo of
        (k - 1) / 2 planes; the stride-2 conv (k = 3) over a left halo of one
        plane, as each shard starts on an even plane and its last output
        reads no plane past its end."""
        dt = m.dtype if m.dtype is not None else xs[0].dtype
        p, ax = (m.kernel_size - 1) // 2, self.layout.axis
        xs = [x.to(dt) for x in xs]
        ws = [w.to(dt) for w in self._rep(m.kernel)]
        if m.stride == 1 and p:
            xs = halo_exchange(xs, ax, p, p, "zero")
            ys = [conv_halo(x, w, ax, p) for x, w in zip(xs, ws)]
        elif m.stride == 1:
            ys = [conv_same(x, w, 1, 0) for x, w in zip(xs, ws)]
        else:   # the MulResUnet's stride-2 down conv, k = 3
            xs = halo_exchange(xs, ax, 1, 0, "zero")
            pads = [(1, 1)] * (xs[0].dim() - 2)
            pads[ax] = (0, 0)
            ys = [conv_same(x, w, 2, pads) for x, w in zip(xs, ws)]
        if m.bias is not None:
            ys = [y + _bcast(b.to(dt), y.ndim) for y, b in zip(ys, self._rep(m.bias))]
        return ys

    def _norm(self, m: Norm, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """``blocks.Norm`` of the whole volume: the shards' float32 sums
        (float64 for float64 shards) all-reduced, over the volume's voxel
        count."""
        axes = [0] + list(range(2, xs[0].ndim))
        parts = []
        for x in xs:
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            parts.append(torch.stack([torch.sum(xf, dim=axes), torch.sum(xf * xf, dim=axes)]))
        count = float(sum(x.numel() // x.shape[1] for x in xs))
        outs = []
        for x, s, scale, bias in zip(xs, all_reduce(parts), self._rep(m.scale),
                                     self._rep(m.bias)):
            mean = s[0] / count
            var = torch.clamp(s[1] / count - mean * mean, min=0.0)
            g = scale * torch.rsqrt(var + m.eps)
            b = bias - mean * g
            outs.append(x * _bcast(g.to(x.dtype), x.ndim) + _bcast(b.to(x.dtype), x.ndim))
        return outs

    def _cna(self, m, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        return [m.act(y) for y in self._norm(m.Norm_0, self._conv(m.Conv_0, xs))]

    def _upsample(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """The x2 upsample: 'nearest' is local; the linear one upsamples each
        shard with one plane of each neighbour (a copy of its own edge plane
        at the volume's ends, as the resize clamps there) and crops the two
        output planes on each side those planes alone decide."""
        mode = self.model.upsample_mode
        if mode == "nearest":
            return [upsample(x, 2, mode) for x in xs]
        dim = self.layout.dim
        ys = [upsample(e, 2, mode) for e in halo_exchange(xs, self.layout.axis, 1, 1,
                                                          "replicate")]
        return [y.narrow(dim, 2, y.shape[dim] - 4) for y in ys]

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
        d = self._upsample(d)
        y = [torch.cat([a, b], dim=1) for a, b in zip(s, d)] if s is not None else d
        return self._block(m.get_submodule(names["dec"]), i, y)
