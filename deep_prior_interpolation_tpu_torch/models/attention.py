"""Attention modules and attention U-Nets, 2D (counterpart of ``models/attention.py``).

The CBAM channel gate (a shared two-layer MLP on max- and mean-pooled
features) and spatial gate, CBAM, the additive grid-attention gate, the
plain attention U-Net (a library component, as in the JAX package) and the
grid-gated attention MultiRes U-Net that ``--net attmultiunet`` builds.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from .blocks import (Compact, Conv, ConvNormAct, Dense, Dropout, Norm, concat_crop,
                     get_activation, upsample)
from .mulresunet import MultiResBlock


def _crop_front(x: torch.Tensor, spatial) -> torch.Tensor:
    return x[(slice(None), slice(None)) + tuple(slice(0, s) for s in spatial)]


class ChannelGate(Compact):
    """SE-style channel gate on max + mean pooled features."""

    def __init__(self, reduction_ratio: int = 4):
        super().__init__()
        self.reduction_ratio = reduction_ratio

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        axes = tuple(range(2, x.ndim))
        d0 = self.child("Dense", lambda: Dense(c, c // self.reduction_ratio))
        d1 = self.child("Dense", lambda: Dense(c // self.reduction_ratio, c))

        def mlp(v):
            return d1(F.relu(d0(v)))
        gate = torch.sigmoid(mlp(torch.amax(x, dim=axes)) + mlp(torch.mean(x, dim=axes)))
        return x * gate.view(gate.shape + (1,) * len(axes))


class SpatialGate(Compact):
    """Spatial gate on the channel max | mean."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.kernel_size = kernel_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = torch.cat([torch.amax(x, dim=1, keepdim=True),
                            torch.mean(x, dim=1, keepdim=True)], 1)
        g = self.child("Conv", lambda: Conv(2, 1, self.kernel_size, ndim=x.ndim - 2))(pooled)
        g = torch.sigmoid(self.child("Norm", lambda: Norm(1))(g))
        return x * g


class CBAM(Compact):
    """Convolutional block attention module: channel gate, then spatial gate."""

    def __init__(self, reduction_ratio: int = 16, kernel_size: int = 7):
        super().__init__()
        self.reduction_ratio, self.kernel_size = reduction_ratio, kernel_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.child("ChannelGate", lambda: ChannelGate(self.reduction_ratio))(x)
        return self.child("SpatialGate", lambda: SpatialGate(self.kernel_size))(x)


class GridAttentionBlock(Compact):
    """Additive grid attention: ``g`` is the coarser gating signal, ``x``
    the skip feature one scale finer; returns ``x`` weighted by the
    upsampled attention map."""

    def __init__(self, f_int: int):
        super().__init__()
        self.f_int = f_int

    def forward(self, g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        nd = x.ndim - 2

        def norm(h):
            return self.child("Norm", lambda: Norm(h.shape[1]))(h)
        g1 = norm(self.child("Conv", lambda: Conv(g.shape[1], self.f_int, 1, ndim=nd))(g))
        x1 = norm(self.child("Conv", lambda: Conv(x.shape[1], self.f_int, 3, stride=2,
                                                  ndim=nd))(x))
        spatial = [min(a, b) for a, b in zip(g1.shape[2:], x1.shape[2:])]
        psi = F.relu(_crop_front(g1, spatial) + _crop_front(x1, spatial))
        psi = torch.sigmoid(self.child("Conv", lambda: Conv(psi.shape[1], 1, 1, ndim=nd))(psi))
        psi = upsample(psi, 2, "bilinear")
        spatial = [min(a, b) for a, b in zip(psi.shape[2:], x.shape[2:])]
        return _crop_front(x, spatial) * _crop_front(psi, spatial)


class AttMulResUnet(Compact):
    """Attention MultiRes U-Net, 2D only, input (N, in_channels, H, W)."""

    def __init__(self, in_channels: int, out_channels: int = 1, ndim: int = 2,
                 filters: Sequence[int] = (16, 32, 64, 128, 256), alpha: float = 1.67,
                 act: str = "LeakyReLU", last_act: Optional[str] = None,
                 use_bias: bool = True, upsample_mode: str = "nearest",
                 dropout: float = 0.0):
        super().__init__()
        if ndim != 2:
            raise ValueError("AttMulResUnet is 2D-only")
        self.out_channels, self.filters, self.alpha = out_channels, tuple(filters), alpha
        self.act_name, self.act = act, get_activation(act)
        self.use_bias, self.upsample_mode, self.rate = use_bias, upsample_mode, dropout
        last = None if (isinstance(last_act, str) and last_act.lower() == "none") else last_act
        self.last_act = get_activation(last)
        self.drop = Dropout(dropout)
        self.build(torch.zeros((1, in_channels) + (2 ** (len(self.filters) - 1),) * 2))

    def _block(self, h: torch.Tensor, u: int) -> torch.Tensor:
        return self.child("MultiResBlock", lambda: MultiResBlock(
            h.shape[1], u, 2, alpha=self.alpha, act=self.act_name, use_bias=self.use_bias,
            drop=self.rate))(h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.filters)
        feats = []
        h = x
        for i in range(n):  # encoder
            if i > 0:
                h = self.child("Conv", lambda: Conv(h.shape[1], h.shape[1], 3, stride=2,
                                                    ndim=2, use_bias=self.use_bias))(h)
                h = self.drop(self.act(self.child("Norm", lambda: Norm(h.shape[1]))(h)))
            h = self._block(h, self.filters[i])
            feats.append(h)
        for i in range(1, n):  # decoder with grid-gated skips
            g, s = feats[-i], feats[-(i + 1)]
            att = self.child("GridAttentionBlock",
                             lambda: GridAttentionBlock(self.filters[-i]))(g, s)
            h = concat_crop([att, upsample(g, 2, self.upsample_mode)])
            h = self._block(h, self.filters[-(i + 1)])
            feats[-(i + 1)] = h
        out = self.child("Conv", lambda: Conv(h.shape[1], self.out_channels, 1, ndim=2,
                                              use_bias=self.use_bias))(h)
        return self.last_act(out)


class AttentionUnet(Compact):
    """Plain 2D U-Net with optional CBAM gates (a library component):
    max-pool encoder, bilinear-upsample decoder, widths 16 to 256."""

    def __init__(self, in_channels: int, out_channels: int = 1, act: str = "LeakyReLU",
                 use_bias: bool = True, att: str = "cbam", reduce_ratio: int = 4):
        super().__init__()
        self.out_channels, self.act, self.use_bias = out_channels, act, use_bias
        self.att, self.reduce_ratio = att, reduce_ratio
        self.build(torch.zeros((1, in_channels, 16, 16)))

    def _att(self, x: torch.Tensor) -> torch.Tensor:
        if self.att == "cbam":
            return self.child("CBAM", lambda: CBAM(self.reduce_ratio, 7))(x)
        return x

    def _block(self, h: torch.Tensor, f: int) -> torch.Tensor:
        for _ in range(2):
            h = self.child("ConvNormAct", lambda: ConvNormAct(
                h.shape[1], f, 3, ndim=2, act=self.act, use_bias=self.use_bias))(h)
        return h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def pool(h):
            return F.max_pool2d(h, 2, 2)
        d1 = self._att(self._block(x, 16))
        d2 = self._att(self._block(pool(d1), 32))
        d3 = self._att(self._block(pool(d2), 64))
        d4 = self._att(self._block(pool(d3), 128))
        up = upsample(self._block(pool(d4), 256), 2, "bilinear")
        for skip, f in ((d4, 128), (d3, 64), (d2, 32)):
            h = self._att(self._block(concat_crop([skip, up]), f))
            up = upsample(h, 2, "bilinear")
        h = self._att(self._block(concat_crop([d1, up]), 16))
        return self.child("Conv", lambda: Conv(h.shape[1], self.out_channels, 3, ndim=2,
                                               use_bias=self.use_bias))(h)
