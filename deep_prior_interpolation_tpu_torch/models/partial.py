"""Partial-convolution U-Net, a mask-aware inpainting net (counterpart of ``models/partial.py``).

The partial conv convolves ``x * mask``, divides by the count of valid mask
entries under the kernel (a zero-padded window sum of the mask's channel
sum), re-adds the bias, zeroes the holes and passes on the updated mask. The
net is a 5-level, 48-channel encoder of partial blocks and a conv /
nearest-upsample decoder, 2D or 3D. It takes ``(x, mask)``
(``takes_mask``): the solver hands it the sampling mask broadcast to the
input depth.

dtypes follow the JAX package: the partial conv is flax's ``nn.Conv``, which
computes in float32 whatever its input (``FlaxConv``), so all after it runs
in float32 too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .blocks import (Compact, Conv, Dropout, FlaxConv, Norm, concat_crop,
                     get_activation, upsample)


def _window_sum(m: torch.Tensor, k: int, stride: int, p: int) -> torch.Tensor:
    """Sum over each k^ndim window (zero padding p) of an (N, 1, *spatial)
    tensor, in its dtype."""
    pool = (F.avg_pool2d, F.avg_pool3d)[m.ndim - 4]
    return pool(F.pad(m, (p, p) * (m.ndim - 2)), k, stride, divisor_override=1)


class PartialConv(Compact):
    """Mask-renormalising conv, 2D or 3D: ``forward(x, mask)`` returns the
    output and the updated mask."""

    def __init__(self, features: int, kernel_size: int = 3, stride: int = 1,
                 ndim: int = 2, use_bias: bool = False, use_norm: bool = True,
                 act: str = "ReLU", drop: float = 0.0):
        super().__init__()
        self.features, self.kernel_size, self.stride, self.ndim = (features, kernel_size,
                                                                   stride, ndim)
        self.use_bias, self.use_norm = use_bias, use_norm
        self.act = get_activation(act)
        self.drop = Dropout(drop)
        if use_bias:  # flax makes it in the input's dtype; float32 here
            self.bias = torch.nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor):
        k, p = self.kernel_size, (self.kernel_size - 1) // 2
        conv = self.child("Conv", lambda: FlaxConv(x.shape[1], self.features, k, self.stride,
                                                   self.ndim, use_bias=False, init="kaiming"))
        out = conv(x * mask)
        counts = _window_sum(mask.sum(dim=1, keepdim=True), k, self.stride, p)
        holes = counts == 0
        counts = torch.where(holes, torch.ones_like(counts), counts)
        out = out / counts
        if self.use_bias:
            out = out + self.bias.to(x.dtype).view((1, -1) + (1,) * self.ndim)
        out = torch.where(holes, torch.zeros((), dtype=out.dtype, device=out.device), out)
        new_mask = (~holes).to(x.dtype).expand(out.shape)
        if self.use_norm:
            out = self.child("Norm", lambda: Norm(out.shape[1]))(out)
        return self.drop(self.act(out)), new_mask


class PartialBlock(Compact):
    """Partial conv, then one stride-2 conv applied to both the features and
    the mask, each dropped out on its own."""

    def __init__(self, features: int, ndim: int, use_norm: bool, act: str,
                 use_bias: bool, drop: float):
        super().__init__()
        self.features, self.ndim, self.use_norm, self.act_name = features, ndim, use_norm, act
        self.use_bias, self.rate = use_bias, drop
        self.drop = Dropout(drop)

    def forward(self, x: torch.Tensor, mask: torch.Tensor):
        x, mask = self.child("PartialConv", lambda: PartialConv(
            self.features, 3, 1, self.ndim, use_bias=False, use_norm=self.use_norm,
            act=self.act_name, drop=self.rate))(x, mask)
        down = self.child("Conv", lambda: Conv(x.shape[1], self.features, 3, stride=2,
                                               ndim=self.ndim, use_bias=self.use_bias))
        x, mask = down(x), down(mask)
        return self.drop(x), self.drop(mask)


class PartialUNet(Compact):
    """5-level partial-conv U-Net, 2D/3D, ``forward(x, mask)``; spatial dims
    divisible by 32."""

    takes_mask = True  # the solver passes (x, mask)

    def __init__(self, in_channels: int, out_channels: int = 1, ndim: int = 2,
                 use_norm: bool = True, act: str = "LeakyReLU", use_bias: bool = True,
                 dropout: float = 0.0):
        super().__init__()
        self.out_channels, self.ndim, self.use_norm, self.act_name = (out_channels, ndim,
                                                                     use_norm, act)
        self.use_bias, self.rate = use_bias, dropout
        self.drop = Dropout(dropout)
        x = torch.zeros((1, in_channels) + (32,) * ndim)
        self.build(x, torch.ones_like(x))

    def _conv(self, h: torch.Tensor, features: int) -> torch.Tensor:
        return self.child("Conv", lambda: Conv(h.shape[1], features, 3, ndim=self.ndim,
                                               use_bias=False))(h)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        downs = []
        h, m = x, mask
        for _ in range(5):
            h, m = self.child("PartialBlock", lambda: PartialBlock(
                48, self.ndim, self.use_norm, self.act_name, self.use_bias, self.rate))(h, m)
            downs.append(h)

        def dec(h, f1=96, f2=96):
            h = self._conv(self._conv(h, f1), f2)
            return self.drop(upsample(h, 2, "nearest"))

        up = upsample(downs[4], 2, "nearest")
        for skip in (downs[3], downs[2], downs[1], downs[0]):
            up = dec(concat_crop([skip, up]))
        h = concat_crop([x, up])
        for f in (96, 64, 32, self.out_channels):
            h = self._conv(h, f)
        return h
