"""Multi-resolution U-Net, 2D and 3D (counterpart of ``models/mulresunet.py``).

Inception-style multi-resolution blocks, residual skip paths, stride-2 conv
downsampling, x2 upsampling and a 1x1 (2D) / 3x3 (3D) output head. The 3D
variant adds the two Norms around each block's residual add
(``extra_norm``), puts a Norm after each downsampling conv, and orders its
ResPath as Norm-then-Dropout.

Child modules are created in the order the flax module calls them and carry
its auto-names (``MultiResBlock_0``, ``ResPath_0``, ``Conv_0``, ``Norm_0``,
...), so the parameters of one package map onto the other's by name.

``remat`` runs each MultiResBlock and ResPath of the chosen levels under
``torch.utils.checkpoint`` (non-reentrant), so the backward recomputes their
insides instead of keeping them: level 0 is the first block, level i its
skip path, encoder and decoder. The names stay those of the plain net (flax
prefixes a remat block's name with ``Checkpoint``). Under ``torch.func.vmap``
(one net a lane, ``parallel/mesh.py``) a checkpoint cannot hold the vmapped
block, whose tensors live only inside the vmap: the block's vmap rule
checkpoints the lanes' block as a whole instead, a vmap of the block over
the lanes' inputs and parameters, which the backward runs again.

``phase_space`` runs the largest resolutions on phase tensors
(``ops/phase_space.py``): the same modules, parameters and function; the
levels' boundaries unblock (``depth_to_space``) below a phased level and
upsample straight into phase layout (``upsample_into_phase``) above one.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Union

import torch
from torch import nn
from torch.func import functional_call, vmap
from torch.utils.checkpoint import checkpoint

from ..ops.conv_vjp import conv_impl, current_conv_impl
from ..ops.phase_space import depth_to_space, space_to_depth, upsample_into_phase
from .blocks import (Conv, ConvNormAct, Dropout, Norm, concat_crop,
                     get_activation, upsample)


def multires_width(u: int, alpha: float = 1.67) -> int:
    """Output channels of a multi-res block."""
    w = alpha * u
    return int(w * 0.167) + int(w * 0.333) + int(w * 0.5)


class MultiResBlock(nn.Module):
    """Chained 3x3 convs concatenated + 1x1 shortcut.

    ``phase`` runs the block on phase tensors of depth ``phase_depth``
    (``ops/phase_space.py``): the first conv and the shortcut enter from a
    plain input, or from a phase one with ``phase_in``; everything after
    stays phase (a channel concat commutes with the layout) and the output
    is a phase tensor. Same parameters, same function."""

    def __init__(self, in_channels: int, u: int, ndim: int, alpha: float = 1.67,
                 act: str = "LeakyReLU", use_bias: bool = True, drop: float = 0.0,
                 extra_norm: bool = False, dtype: Optional[torch.dtype] = None,
                 phase: bool = False, phase_in: bool = False, phase_depth: int = 1):
        super().__init__()
        w = alpha * u
        c1, c2, c3 = int(w * 0.167), int(w * 0.333), int(w * 0.5)
        kw = dict(ndim=ndim, act=act, use_bias=use_bias, dtype=dtype)
        pin = dict(phase_in=phase_in, phase_out=True, phase_depth=phase_depth) if phase else {}
        pmid = dict(phase_in=True, phase_out=True, phase_depth=phase_depth) if phase else {}
        lanes = 2 ** (ndim * phase_depth) if phase else 1
        self.out_channels = c1 + c2 + c3
        self.ConvNormAct_0 = ConvNormAct(in_channels, c1, 3, **kw, **pin)
        self.ConvNormAct_1 = ConvNormAct(c1, c2, 3, **kw, **pmid)
        self.ConvNormAct_2 = ConvNormAct(c2, c3, 3, **kw, **pmid)
        self.extra_norm = extra_norm
        if extra_norm:
            self.Norm_0 = Norm(self.out_channels, phase=lanes)
        self.drop = Dropout(drop)
        self.ConvNormAct_3 = ConvNormAct(in_channels, self.out_channels, 1, **kw, **pin)
        if extra_norm:
            self.Norm_1 = Norm(self.out_channels, phase=lanes)
        self.act = get_activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out1 = self.ConvNormAct_0(x)
        out2 = self.ConvNormAct_1(out1)
        out3 = self.ConvNormAct_2(out2)
        out = torch.cat([out1, out2, out3], dim=1)
        if self.extra_norm:
            out = self.Norm_0(out)
        out = self.drop(out)
        out = self.ConvNormAct_3(x) + out
        out = self.act(out)
        if self.extra_norm:
            out = self.Norm_1(out)
        return self.drop(out)


class ResPath(nn.Module):
    """Residual skip path: 3x3 + 1x1 convs added. ``norm_last`` selects the
    2D order Norm(Dropout(act(.))); the 3D one is Dropout(Norm(act(.))).
    ``phase`` runs it on a phase tensor of depth ``phase_depth``."""

    def __init__(self, in_channels: int, f_out: int, ndim: int,
                 act: str = "LeakyReLU", use_bias: bool = True, drop: float = 0.0,
                 norm_last: bool = True, length: int = 1,
                 dtype: Optional[torch.dtype] = None, phase: bool = False,
                 phase_depth: int = 1):
        super().__init__()
        kw = dict(ndim=ndim, act=act, use_bias=use_bias, dtype=dtype)
        if phase:
            kw.update(phase_in=True, phase_out=True, phase_depth=phase_depth)
        lanes = 2 ** (ndim * phase_depth) if phase else 1
        self.length, self.norm_last = length, norm_last
        c = in_channels
        for i in range(length):
            setattr(self, f"ConvNormAct_{2 * i}", ConvNormAct(c, f_out, 3, **kw))
            setattr(self, f"ConvNormAct_{2 * i + 1}", ConvNormAct(c, f_out, 1, **kw))
            setattr(self, f"Norm_{i}", Norm(f_out, phase=lanes))
            c = f_out
        self.drop = Dropout(drop)
        self.act = get_activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.length):
            a = getattr(self, f"ConvNormAct_{2 * i}")(x)
            b = getattr(self, f"ConvNormAct_{2 * i + 1}")(x)
            y = self.act(a + b)
            norm = getattr(self, f"Norm_{i}")
            x = norm(self.drop(y)) if self.norm_last else self.drop(norm(y))
        return x


def _replayed(fn, generators: Sequence[torch.Generator]):
    """``fn`` whose first call draws from ``generators`` as they stand and
    whose later calls (a checkpoint's recompute) draw from those same states
    again, leaving each generator where the step has moved it
    (``torch.utils.checkpoint`` restores only the global generators)."""
    starts = [g.get_state() for g in generators]
    first = [True]

    def run(*args):
        if first[0] or not generators:
            first[0] = False
            return fn(*args)
        now = [g.get_state() for g in generators]
        for g, st in zip(generators, starts):
            g.set_state(st)
        try:
            return fn(*args)
        finally:
            for g, st in zip(generators, now):
                g.set_state(st)
    return run


def checkpointed(module: nn.Module, x: torch.Tensor,
                 generator: Union[torch.Generator, Sequence[torch.Generator], None]
                 ) -> torch.Tensor:
    """``module(x)`` whose backward recomputes the forward. The recompute
    runs under the forward's conv formulation (``conv_impl``: the backward
    may run on another thread); it draws its dropout masks from the
    generator state the forward started from, so it rebuilds the same
    masks, and leaves the generator where the step has moved it. Under
    ``torch.func.vmap`` (``generator`` one a lane, or None) the lanes' block
    is checkpointed as a whole (:class:`_LaneCheckpoint`)."""
    if torch._C._functorch.is_batchedtensor(x):
        names = tuple(n for n, _ in module.named_parameters())
        params = [p for _, p in module.named_parameters()]
        return _LaneCheckpoint.apply(x, module, names, tuple(generator or ()),
                                     current_conv_impl(), *params)
    return recomputed(module, (x,), generator)


def recomputed(fn: Callable, args: Sequence[torch.Tensor],
               generator: Optional[torch.Generator]):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant): the
    backward runs ``fn`` again, under the forward's conv formulation and
    with ``generator`` replayed from the state the forward started from
    (``_replayed``), so the recompute draws the same dropout masks."""
    mode = current_conv_impl()

    def forward(*a):
        with conv_impl(mode):
            return fn(*a)
    run = _replayed(forward, [generator] if generator is not None else [])
    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


class _LaneCheckpoint(torch.autograd.Function):
    """A block of a vmapped net, checkpointed over its lanes: the vmap rule
    takes the lanes' input and parameters and checkpoints a vmap of the
    block over them (``functional_call`` with each lane's parameters), so
    the recompute in the backward needs nothing of the outer vmap."""

    @staticmethod
    def forward(x, module, names, generators, mode, *params):
        raise RuntimeError("_LaneCheckpoint runs only under torch.func.vmap")

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("_LaneCheckpoint runs only under torch.func.vmap")

    @staticmethod
    def vmap(info, in_dims, x, module, names, generators, mode, *params):
        b = info.batch_size
        x, *params = (v.movedim(d, 0) if d is not None else v.expand((b,) + tuple(v.shape))
                      for v, d in zip((x,) + params, (in_dims[0],) + in_dims[5:]))

        def lanes(h: torch.Tensor, *ps: torch.Tensor) -> torch.Tensor:
            def one(h1, *p1):
                return functional_call(module, dict(zip(names, p1)), (h1,))
            with conv_impl(mode):
                return vmap(one)(h, *ps)
        run = _replayed(lanes, list(generators))
        return checkpoint(run, x, *params, use_reentrant=False, preserve_rng_state=False), 0


class MulResUnet(nn.Module):
    """MultiRes U-Net (2D when ndim=2, 3D when ndim=3), input (1, C, *spatial).

    ``dtype=torch.bfloat16`` runs every conv in bf16 (parameters and Norm
    statistics stay float32); the output is cast back to the input dtype.
    ``remat_levels`` None checkpoints every level, N the N largest.

    ``phase_space`` runs resolutions 0..``phase_levels``-1 (all for None) on
    phase tensors (``ops/phase_space.py``), the first ``phase_deep_levels``
    of them at phase depth 2 (channels x 4^ndim at 1/4 resolution): the same
    parameters (names and shapes those of the plain net) and the same
    function, up to rounding. The spatial dims must be divisible by
    2^(r + depth) at each phased resolution r.
    """

    def __init__(self, in_channels: int, out_channels: int = 1, ndim: int = 2,
                 filters: Sequence[int] = (16, 32, 64, 128, 256),
                 skip: Sequence[int] = (16, 32, 64, 128), alpha: float = 1.67,
                 act: str = "LeakyReLU", last_act: Optional[str] = None,
                 use_bias: bool = True, upsample_mode: str = "nearest",
                 dropout: float = 0.0, dtype: Optional[torch.dtype] = None,
                 remat: bool = False, remat_levels: Optional[int] = None,
                 phase_space: bool = False, phase_levels: Optional[int] = 3,
                 phase_deep_levels: int = 0):
        super().__init__()
        if len(filters) != len(skip) + 1:
            raise ValueError("filters must be one longer than skip")
        self.ndim, self.dtype = ndim, dtype
        self.remat, self.remat_levels = remat, remat_levels
        self.filters, self.skip = tuple(filters), tuple(skip)
        self.upsample_mode = upsample_mode
        self.phase_space, self.phase_levels = phase_space, phase_levels
        self.phase_deep_levels = phase_deep_levels
        self.act = get_activation(act)
        self.drop = Dropout(dropout)
        last = None if (isinstance(last_act, str)
                        and last_act.lower() == "none") else last_act
        self.last_act = get_activation(last)
        is3d = ndim == 3
        bkw = dict(ndim=ndim, alpha=alpha, act=act, use_bias=use_bias,
                   drop=dropout, extra_norm=is3d, dtype=dtype)
        counts: Dict[str, int] = {}

        def add(kind: str, module: nn.Module) -> str:
            name = f"{kind}_{counts.get(kind, 0)}"
            counts[kind] = counts.get(kind, 0) + 1
            self.add_module(name, module)
            return name

        # per level i >= 1: the names of its modules, in flax call order
        self.levels: Dict[int, Dict[str, Optional[str]]] = {}

        def build_level(i: int, c_h: int) -> int:
            ph, dp = self.phased(i - 1), max(self.pdepth(i - 1), 1)
            enc_ph, enc_dp = self.phased(i), max(self.pdepth(i), 1)
            names: Dict[str, Optional[str]] = {"path": None, "norm": None}
            if skip[i - 1] != 0:
                names["path"] = add("ResPath", ResPath(
                    c_h, skip[i - 1], ndim, act=act, use_bias=use_bias,
                    drop=dropout, norm_last=not is3d, dtype=dtype, phase=ph,
                    phase_depth=dp))
            # with a phase input the stride-2 conv is the phase exit
            names["down"] = add("Conv", Conv(c_h, c_h, 3, stride=2, ndim=ndim,
                                             use_bias=use_bias, dtype=dtype,
                                             phase_in=ph, phase_depth=dp))
            if is3d:
                names["norm"] = add("Norm", Norm(c_h))
            enc = MultiResBlock(c_h, filters[i], **bkw, phase=enc_ph, phase_depth=enc_dp)
            names["enc"] = add("MultiResBlock", enc)
            c_d = enc.out_channels
            if i < len(filters) - 1:
                c_d = build_level(i + 1, c_d)
            c_cat = c_d + (skip[i - 1] if skip[i - 1] != 0 else 0)
            dec = MultiResBlock(c_cat, filters[i - 1], **bkw, phase=ph, phase_in=ph,
                                phase_depth=dp)
            names["dec"] = add("MultiResBlock", dec)
            self.levels[i] = names
            return dec.out_channels

        dp0 = max(self.pdepth(0), 1)
        block0 = MultiResBlock(in_channels, filters[0], **bkw, phase=self.phased(0),
                               phase_depth=dp0)
        self.block0 = add("MultiResBlock", block0)
        c0 = build_level(1, block0.out_channels)
        self.head = add("Conv", Conv(c0, out_channels, 1 if ndim == 2 else 3,
                                     ndim=ndim, use_bias=use_bias, dtype=dtype,
                                     phase_in=self.phased(0), phase_out=self.phased(0),
                                     phase_depth=dp0))

    def phased(self, res: int) -> bool:
        """Does resolution ``res`` run on phase tensors?"""
        return self.phase_space and (self.phase_levels is None or res < self.phase_levels)

    def pdepth(self, res: int) -> int:
        """Phase depth of resolution ``res`` (0: plain)."""
        if not self.phased(res):
            return 0
        return 2 if res < self.phase_deep_levels else 1

    def remats(self, level: int) -> bool:
        """Does remat checkpoint the MultiResBlocks and ResPaths of ``level``?"""
        return self.remat and (self.remat_levels is None or level < self.remat_levels)

    def _block(self, name: str, level: int, x: torch.Tensor) -> torch.Tensor:
        """A MultiResBlock or ResPath of ``level``, checkpointed where remat
        covers the level."""
        m = self.get_submodule(name)
        if not self.remats(level):
            return m(x)
        return checkpointed(m, x, self.drop.generator if self.drop.rate > 0 else None)

    def _level(self, i: int, h: torch.Tensor) -> torch.Tensor:
        """Resolution i-1 in, resolution i-1 out: phase tensors where that
        resolution is phased."""
        names = self.levels[i]
        ph, dp = self.phased(i - 1), max(self.pdepth(i - 1), 1)
        s = self._block(names["path"], i, h) if names["path"] else None
        d = self.get_submodule(names["down"])(h)
        if names["norm"]:
            d = self.get_submodule(names["norm"])(d)
        d = self.drop(self.act(d))
        d = self._block(names["enc"], i, d)
        if i < len(self.filters) - 1:
            d = self._level(i + 1, d)
        if self.phased(i):
            for _ in range(max(self.pdepth(i), 1)):
                d = depth_to_space(d)
        if ph:
            # the x2 upsample lands in phase layout: its phase grid is d's grid
            d = upsample_into_phase(d, "nearest" if self.upsample_mode == "nearest"
                                    else "linear")
            for _ in range(dp - 1):
                d = space_to_depth(d)
        else:
            d = upsample(d, 2, self.upsample_mode)
        y = concat_crop([s, d]) if s is not None else d
        return self._block(names["dec"], i, y)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_dtype = x.dtype
        for r in range(len(self.filters)):
            m = 2 ** (r + self.pdepth(r))
            if self.phased(r) and any(dim % m for dim in x.shape[2:]):
                raise ValueError(f"phase level {r} needs spatial dims divisible by {m}, got "
                                 f"{tuple(x.shape[2:])}: raise pad_multiple or lower "
                                 f"phase_levels")
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self._block(self.block0, 0, x)
        x = self._level(1, x)
        x = self.get_submodule(self.head)(x)
        if self.phased(0):
            for _ in range(max(self.pdepth(0), 1)):
                x = depth_to_space(x)
        x = self.last_act(x)
        return x.to(in_dtype)
