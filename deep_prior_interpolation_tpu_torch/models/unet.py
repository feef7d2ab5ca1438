"""Plain U-Net (counterpart of ``models/unet.py``).

Double-conv blocks with instance norm on the way down, max-pool
downsampling, a deconv-or-upsample up path with center-crop skip concat,
optional ``concat_x`` multiscale input injection and ``more_layers`` extra
depth; 2D and 3D. The nets compute in their input's dtype, but a
``'deconv'`` up path computes in float32, as flax's ``ConvTranspose`` does.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import (Compact, Conv, ConvTranspose, Dropout, concat_crop,
                     get_activation, upsample)


class InstanceNorm(nn.Module):
    """Per-sample, per-channel spatial norm without parameters: mean and
    population variance (ddof 0), each rounded to the input's dtype."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axes = tuple(range(2, x.ndim))
        xf = x.float()
        mean = xf.mean(dim=axes, keepdim=True).to(x.dtype)
        var = xf.var(dim=axes, keepdim=True, correction=0).to(x.dtype)
        return (x - mean) / torch.sqrt(var + self.eps)


def _pool(x: torch.Tensor, mode: str) -> torch.Tensor:
    """2x max or mean pooling (floor sizes); the mean sums in float32 (the
    CPU has no bfloat16 3D average pooling) and rounds to x's dtype."""
    if mode == "max":
        return (F.max_pool2d, F.max_pool3d)[x.ndim - 4](x, 2, 2)
    return (F.avg_pool2d, F.avg_pool3d)[x.ndim - 4](x.float(), 2, 2).to(x.dtype)


class UNetConv(Compact):
    """Double conv block: (conv, instance norm, activation, dropout) x 2."""

    def __init__(self, features: int, ndim: int, act: str, use_bias: bool,
                 norm: bool = True, drop: float = 0.0):
        super().__init__()
        self.features, self.ndim, self.use_bias, self.norm = features, ndim, use_bias, norm
        self.act = get_activation(act)
        self.inorm = InstanceNorm()
        self.drop = Dropout(drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for _ in range(2):
            x = self.child("Conv", lambda: Conv(x.shape[1], self.features, 3, ndim=self.ndim,
                                                use_bias=self.use_bias))(x)
            if self.norm:
                x = self.inorm(x)
            x = self.drop(self.act(x))
        return x


class UNet(Compact):
    """U-Net, input (N, in_channels, *spatial); ``upsample_mode`` 'deconv',
    'nearest' or a linear mode."""

    def __init__(self, in_channels: int, out_channels: int = 1, ndim: int = 2,
                 filters: Sequence[int] = (16, 32, 64, 128, 256), more_layers: int = 0,
                 concat_x: bool = False, act: str = "ReLU", last_act: Optional[str] = None,
                 use_bias: bool = True, upsample_mode: str = "nearest",
                 dropout: float = 0.0):
        super().__init__()
        self.out_channels, self.ndim, self.filters = out_channels, ndim, list(filters)
        self.more_layers, self.concat_x, self.act_name = more_layers, concat_x, act
        self.use_bias, self.upsample_mode, self.dropout = use_bias, upsample_mode, dropout
        last = None if (isinstance(last_act, str) and last_act.lower() == "none") else last_act
        self.last_act = get_activation(last)
        self.drop = Dropout(dropout)
        self.build(torch.zeros((1, in_channels) + (2 ** (4 + more_layers),) * ndim))

    def _up(self, x: torch.Tensor, features: int) -> torch.Tensor:
        if self.upsample_mode == "deconv":
            return self.child("ConvTranspose", lambda: ConvTranspose(
                x.shape[1], features, 4, 2, self.ndim, self.use_bias))(x)
        y = upsample(x, 2, self.upsample_mode)
        return self.child("Conv", lambda: Conv(y.shape[1], features, 3, ndim=self.ndim,
                                               use_bias=self.use_bias))(y)

    def _conv(self, h: torch.Tensor, features: int, norm: bool) -> torch.Tensor:
        return self.child("UNetConv", lambda: UNetConv(
            features, self.ndim, self.act_name, self.use_bias, norm, self.dropout))(h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = self.filters
        n_down = 4 + self.more_layers
        cx = x.shape[1] if self.concat_x else 0
        # multiscale raw-input pyramid for concat_x
        downsampled = [x]
        for _ in range(n_down if self.concat_x else 0):
            downsampled.append(_pool(downsampled[-1], "avg"))

        def maybe_cat(h, i):
            return concat_crop([h, downsampled[i]]) if self.concat_x else h

        h = maybe_cat(self._conv(x, f[0] - cx, True), 0)
        skips = [h]
        for i in range(1, 5):
            h = self.drop(_pool(h, "max"))
            h = self.drop(self._conv(h, f[i] - cx, True))
            h = maybe_cat(h, i)
            skips.append(h)
        for j in range(self.more_layers):
            h = _pool(h, "max")
            h = maybe_cat(self._conv(h, f[4], True), 5 + j)
            skips.append(h)

        up = skips[-1]
        for j in range(self.more_layers):
            up = self._up(up, f[4])
            up = self._conv(concat_crop([up, skips[-(2 + j)]]), f[4], False)
        for i in range(4, 0, -1):
            up = self._up(up, f[i - 1])
            up = self._conv(concat_crop([up, skips[i - 1]]), f[i - 1], False)
            up = self.drop(up)

        out = self.child("Conv", lambda: Conv(up.shape[1], self.out_channels, 1,
                                              ndim=self.ndim, use_bias=self.use_bias))(up)
        return self.last_act(out)
