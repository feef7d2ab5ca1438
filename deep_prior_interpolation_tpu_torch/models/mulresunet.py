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
prefixes a remat block's name with ``Checkpoint``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .blocks import (Conv, ConvNormAct, Dropout, Norm, concat_crop,
                     get_activation, upsample)


def multires_width(u: int, alpha: float = 1.67) -> int:
    """Output channels of a multi-res block."""
    w = alpha * u
    return int(w * 0.167) + int(w * 0.333) + int(w * 0.5)


class MultiResBlock(nn.Module):
    """Chained 3x3 convs concatenated + 1x1 shortcut."""

    def __init__(self, in_channels: int, u: int, ndim: int, alpha: float = 1.67,
                 act: str = "LeakyReLU", use_bias: bool = True, drop: float = 0.0,
                 extra_norm: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        w = alpha * u
        c1, c2, c3 = int(w * 0.167), int(w * 0.333), int(w * 0.5)
        kw = dict(ndim=ndim, act=act, use_bias=use_bias, dtype=dtype)
        self.out_channels = c1 + c2 + c3
        self.ConvNormAct_0 = ConvNormAct(in_channels, c1, 3, **kw)
        self.ConvNormAct_1 = ConvNormAct(c1, c2, 3, **kw)
        self.ConvNormAct_2 = ConvNormAct(c2, c3, 3, **kw)
        self.extra_norm = extra_norm
        if extra_norm:
            self.Norm_0 = Norm(self.out_channels)
        self.drop = Dropout(drop)
        self.ConvNormAct_3 = ConvNormAct(in_channels, self.out_channels, 1, **kw)
        if extra_norm:
            self.Norm_1 = Norm(self.out_channels)
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
    2D order Norm(Dropout(act(.))); the 3D one is Dropout(Norm(act(.)))."""

    def __init__(self, in_channels: int, f_out: int, ndim: int,
                 act: str = "LeakyReLU", use_bias: bool = True, drop: float = 0.0,
                 norm_last: bool = True, length: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        kw = dict(ndim=ndim, act=act, use_bias=use_bias, dtype=dtype)
        self.length, self.norm_last = length, norm_last
        c = in_channels
        for i in range(length):
            setattr(self, f"ConvNormAct_{2 * i}", ConvNormAct(c, f_out, 3, **kw))
            setattr(self, f"ConvNormAct_{2 * i + 1}", ConvNormAct(c, f_out, 1, **kw))
            setattr(self, f"Norm_{i}", Norm(f_out))
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


def checkpointed(module: nn.Module, x: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """``module(x)`` whose backward recomputes the forward. A recompute
    draws its dropout masks from the generator state the forward started
    from, so it rebuilds the same masks, and leaves the generator where the
    step has moved it (``torch.utils.checkpoint`` restores only the global
    generators)."""
    if generator is None:
        return checkpoint(module, x, use_reentrant=False, preserve_rng_state=False)
    start = generator.get_state()
    first = [True]

    def run(h: torch.Tensor) -> torch.Tensor:
        if first[0]:
            first[0] = False
            return module(h)
        now = generator.get_state()
        generator.set_state(start)
        try:
            return module(h)
        finally:
            generator.set_state(now)
    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


class MulResUnet(nn.Module):
    """MultiRes U-Net (2D when ndim=2, 3D when ndim=3), input (1, C, *spatial).

    ``dtype=torch.bfloat16`` runs every conv in bf16 (parameters and Norm
    statistics stay float32); the output is cast back to the input dtype.
    ``remat_levels`` None checkpoints every level, N the N largest.
    """

    def __init__(self, in_channels: int, out_channels: int = 1, ndim: int = 2,
                 filters: Sequence[int] = (16, 32, 64, 128, 256),
                 skip: Sequence[int] = (16, 32, 64, 128), alpha: float = 1.67,
                 act: str = "LeakyReLU", last_act: Optional[str] = None,
                 use_bias: bool = True, upsample_mode: str = "nearest",
                 dropout: float = 0.0, dtype: Optional[torch.dtype] = None,
                 remat: bool = False, remat_levels: Optional[int] = None,
                 phase_space: bool = False):
        super().__init__()
        if len(filters) != len(skip) + 1:
            raise ValueError("filters must be one longer than skip")
        if phase_space:
            raise NotImplementedError("phase-space execution: ROADMAP A.12")
        self.ndim, self.dtype = ndim, dtype
        self.remat, self.remat_levels = remat, remat_levels
        self.filters, self.skip = tuple(filters), tuple(skip)
        self.upsample_mode = upsample_mode
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
            names: Dict[str, Optional[str]] = {"path": None, "norm": None}
            if skip[i - 1] != 0:
                names["path"] = add("ResPath", ResPath(
                    c_h, skip[i - 1], ndim, act=act, use_bias=use_bias,
                    drop=dropout, norm_last=not is3d, dtype=dtype))
            names["down"] = add("Conv", Conv(c_h, c_h, 3, stride=2, ndim=ndim,
                                             use_bias=use_bias, dtype=dtype))
            if is3d:
                names["norm"] = add("Norm", Norm(c_h))
            enc = MultiResBlock(c_h, filters[i], **bkw)
            names["enc"] = add("MultiResBlock", enc)
            c_d = enc.out_channels
            if i < len(filters) - 1:
                c_d = build_level(i + 1, c_d)
            c_cat = c_d + (skip[i - 1] if skip[i - 1] != 0 else 0)
            dec = MultiResBlock(c_cat, filters[i - 1], **bkw)
            names["dec"] = add("MultiResBlock", dec)
            self.levels[i] = names
            return dec.out_channels

        block0 = MultiResBlock(in_channels, filters[0], **bkw)
        self.block0 = add("MultiResBlock", block0)
        c0 = build_level(1, block0.out_channels)
        self.head = add("Conv", Conv(c0, out_channels, 1 if ndim == 2 else 3,
                                     ndim=ndim, use_bias=use_bias, dtype=dtype))

    def _block(self, name: str, level: int, x: torch.Tensor) -> torch.Tensor:
        """A MultiResBlock or ResPath of ``level``, checkpointed where remat
        covers the level."""
        m = self.get_submodule(name)
        if not self.remat or (self.remat_levels is not None and level >= self.remat_levels):
            return m(x)
        return checkpointed(m, x, self.drop.generator if self.drop.rate > 0 else None)

    def _level(self, i: int, h: torch.Tensor) -> torch.Tensor:
        names = self.levels[i]
        s = self._block(names["path"], i, h) if names["path"] else None
        d = self.get_submodule(names["down"])(h)
        if names["norm"]:
            d = self.get_submodule(names["norm"])(d)
        d = self.drop(self.act(d))
        d = self._block(names["enc"], i, d)
        if i < len(self.filters) - 1:
            d = self._level(i + 1, d)
        d = upsample(d, 2, self.upsample_mode)
        y = concat_crop([s, d]) if s is not None else d
        return self._block(names["dec"], i, y)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_dtype = x.dtype
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self._block(self.block0, 0, x)
        x = self._level(1, x)
        x = self.last_act(self.get_submodule(self.head)(x))
        return x.to(in_dtype)
