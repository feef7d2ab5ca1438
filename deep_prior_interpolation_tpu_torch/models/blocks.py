"""NN building blocks (counterpart of ``models/blocks.py``), channels-first.

Activations are (N, C, *spatial) and conv kernels (O, I, *window), PyTorch's
own layout; ``io/bridge.py`` converts the JAX package's channels-last
parameters at the boundary. Parameter names follow the flax modules
(``Conv``: ``kernel``, ``bias``; ``Norm``: ``scale``, ``bias``) and child
modules carry flax's auto-names (``Conv_0``, ``Norm_0``, ...), so the bridge
is a name-for-name transpose.

* ``Norm`` is batch-of-1 BatchNorm without running statistics: normalise
  over all non-channel axes with float32 statistics, eps 1e-5; ``g`` and
  ``b`` are formed in float32 and applied in the input dtype.
* ``Conv`` pads (k-1)//2 on each side, so stride 2 gives ceil(n/2); the
  input and the float32 kernel are cast to the compute dtype, and the bias
  is added in that dtype.
* ``upsample``: 'nearest' duplicates samples; any other mode is a
  half-pixel-centre linear resize (``align_corners=False``).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv_vjp import conv_same


def get_activation(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    if name is None or name == "none":
        return lambda x: x
    table = {
        "LeakyReLU": lambda x: F.leaky_relu(x, negative_slope=0.2),
        "ReLU": F.relu,
        "ELU": F.elu,
        "Tanh": torch.tanh,
        "Sigmoid": torch.sigmoid,
        "Swish": F.silu,
    }
    if name not in table:
        raise NotImplementedError(f"unknown activation function '{name}'")
    return table[name]


def _bcast(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """(C,) -> (1, C, 1, ...) for an ndim-rank activation."""
    return v.view((1, -1) + (1,) * (ndim - 2))


class Norm(nn.Module):
    """Batch-of-1 BatchNorm: normalise over all non-channel axes."""

    def __init__(self, channels: int, eps: float = 1e-5, phase: int = 1):
        super().__init__()
        if phase != 1:
            raise NotImplementedError("phase-space Norm: ROADMAP A.12")
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        axes = [0] + list(range(2, x.ndim))
        s1 = torch.sum(xf, dim=axes)
        s2 = torch.sum(xf * xf, dim=axes)
        n = float(x.numel() // x.shape[1])
        mean = s1 / n
        var = torch.clamp(s2 / n - mean * mean, min=0.0)
        g = self.scale * torch.rsqrt(var + self.eps)
        b = self.bias - mean * g
        return x * _bcast(g.to(x.dtype), x.ndim) + _bcast(b.to(x.dtype), x.ndim)


class Conv(nn.Module):
    """Same-pad conv (symmetric (k-1)//2 zero padding), 2D or 3D.

    ``dtype`` is the compute dtype (bfloat16 for the fast path); the
    parameters stay float32. The kernel is allocated as zeros and drawn by
    ``models.init.init_weights``.
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, ndim: int = 2, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 phase_in: bool = False, phase_out: bool = False):
        super().__init__()
        if phase_in or phase_out:
            raise NotImplementedError("phase-space Conv: ROADMAP A.12")
        self.kernel_size, self.stride, self.dtype = kernel_size, stride, dtype
        self.kernel = nn.Parameter(
            torch.zeros((features, in_channels) + (kernel_size,) * ndim))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype if self.dtype is not None else x.dtype
        y = conv_same(x.to(dt), self.kernel.to(dt), self.stride,
                      (self.kernel_size - 1) // 2)
        if self.bias is not None:
            y = y + _bcast(self.bias.to(dt), y.ndim)
        return y


class ConvNormAct(nn.Module):
    """conv -> Norm -> activation."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, ndim: int = 2, use_bias: bool = True,
                 act: str = "LeakyReLU", dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.Conv_0 = Conv(in_channels, features, kernel_size, stride, ndim,
                           use_bias, dtype=dtype)
        self.Norm_0 = Norm(features)
        self.act = get_activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.Norm_0(self.Conv_0(x)))


def center_crop_to(x: torch.Tensor, spatial: Sequence[int]) -> torch.Tensor:
    """Center-crop the spatial dims (all after N, C) of ``x`` to ``spatial``."""
    slices = [slice(None), slice(None)]
    for dim, tgt in zip(x.shape[2:], spatial):
        d = (dim - tgt) // 2
        slices.append(slice(d, d + tgt))
    return x[tuple(slices)]


def concat_crop(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Concat along channels after center-cropping spatial dims to the min."""
    spatial = [min(x.shape[d] for x in xs) for d in range(2, xs[0].ndim)]
    return torch.cat([center_crop_to(x, spatial) for x in xs], dim=1)


def upsample(x: torch.Tensor, factor: int = 2, mode: str = "nearest") -> torch.Tensor:
    """Upsample the spatial dims by ``factor``: 'nearest' duplicates samples;
    'bilinear'/'trilinear'/'linear' is a half-pixel linear resize."""
    ndim = x.ndim - 2
    if mode == "nearest":
        for ax in range(2, x.ndim):
            x = torch.repeat_interleave(x, factor, dim=ax)
        return x
    lin = {1: "linear", 2: "bilinear", 3: "trilinear"}[ndim]
    return F.interpolate(x, scale_factor=factor, mode=lin, align_corners=False)


class Dropout(nn.Module):
    """Dropout at rate 0 (the identity); rate > 0 is not ported yet."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        if rate > 0.0:
            raise NotImplementedError("dropout > 0: ROADMAP A.5")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x
