"""Skip net, the classic Deep-Image-Prior autoencoder (counterpart of ``models/skip.py``).

Per scale a 1x1-conv skip branch and a deeper path (a stride-2 conv and a
conv), Norm everywhere, an optional 1x1 refinement conv on the way up,
nearest or linear upsampling, stride / avg / max / lanczos downsampling and
zero or reflection padding; 2D and 3D, recursive over scales. The children
are made in the flax module's call order and carry its names (``Conv_0``,
``Norm_0``, ...). Each Norm that an activation follows applies it
(``Norm.forward(h, act)``), so that on the card LeakyReLU runs inside the
Norm's kernel pair; the concatenation's Norm has none after it.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from .blocks import (Compact, Conv, Dropout, Norm, concat_crop, downsample_pool,
                     get_activation, lanczos_downsample, upsample)


def _per_scale(v, n):
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v] * n


class SkipNet(Compact):
    """2D/3D DIP skip autoencoder, input (N, in_channels, *spatial)."""

    def __init__(self, in_channels: int, out_channels: int = 1, ndim: int = 2,
                 filters: Sequence[int] = (16, 32, 64, 128, 128),
                 skip: Sequence[int] = (4, 4, 4, 4, 4),
                 filter_size_down: Union[int, Sequence[int]] = 3,
                 filter_size_up: Union[int, Sequence[int]] = 3,
                 filter_skip_size: int = 1, act: str = "LeakyReLU",
                 last_act: Optional[str] = None, use_bias: bool = True,
                 pad: str = "zero", upsample_mode: Union[str, Sequence[str]] = "nearest",
                 downsample_mode: Union[str, Sequence[str]] = "stride",
                 need1x1_up: bool = True, dropout: float = 0.0):
        super().__init__()
        self.out_channels, self.ndim = out_channels, ndim
        self.filters, self.skip = tuple(filters), tuple(skip)
        self.filter_size_down, self.filter_size_up = filter_size_down, filter_size_up
        self.filter_skip_size, self.use_bias, self.pad = filter_skip_size, use_bias, pad
        self.upsample_mode, self.downsample_mode = upsample_mode, downsample_mode
        self.need1x1_up = need1x1_up
        self.act_name, self.act = act, get_activation(act)
        last = None if (isinstance(last_act, str) and last_act.lower() == "none") else last_act
        self.last_act = get_activation(last)
        self.drop = Dropout(dropout)
        self.build(torch.zeros((1, in_channels) + (self._probe_side(in_channels),) * ndim))

    def _probe_side(self, in_channels: int) -> int:
        """The planes a side of the build's input: 2^(n + 1) for n scales,
        or, where a kernel size is even (a same-pad conv of even k drops a
        plane, as the JAX module's does) or the padding reflects (which
        takes fewer planes than the axis has), the least such power of two
        at which every conv still gets its window, found by building on the
        meta device."""
        n = len(self.filters)
        side = 2 ** (n + 1)
        sizes = (_per_scale(self.filter_size_down, n) + _per_scale(self.filter_size_up, n)
                 + [self.filter_skip_size])
        if all(k % 2 for k in sizes) and self.pad != "reflection":
            return side
        while True:
            try:
                with torch.device("meta"):
                    self.build(torch.zeros((1, in_channels) + (side,) * self.ndim))
                return side
            except RuntimeError:
                if side >= 2 ** 12:
                    raise
                side *= 2
            finally:   # unbuilt again: the real build follows
                for name in self._order:
                    delattr(self, name)
                self._order, self._counts, self._built = [], {}, False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the CLI passes one skip width fewer than filters: pad with the last
        skip_ch = list(self.skip)
        while len(skip_ch) < len(self.filters):
            skip_ch.append(skip_ch[-1] if skip_ch else 4)
        n = len(self.filters)
        up_modes = _per_scale(self.upsample_mode, n)
        down_modes = _per_scale(self.downsample_mode, n)
        fs_down = _per_scale(self.filter_size_down, n)
        fs_up = _per_scale(self.filter_size_up, n)
        drop = self.drop

        def conv_block(h, features, k, stride=1, down_mode="stride"):
            """A pooling or lanczos mode turns the strided conv into a
            stride-1 conv and an explicit downsample."""
            pool, s = None, stride
            if stride != 1 and down_mode != "stride":
                pool, s = down_mode, 1
            h = self.child("Conv", lambda: Conv(h.shape[1], features, k, stride=s,
                                                ndim=self.ndim, use_bias=self.use_bias,
                                                pad=self.pad))(h)
            if pool in ("avg", "max"):
                h = downsample_pool(h, stride, pool)
            elif pool in ("lanczos2", "lanczos3"):
                h = lanczos_downsample(h, stride, 2 if pool == "lanczos2" else 3)
            return h

        def norm(h, act=None):
            return self.child("Norm", lambda: Norm(h.shape[1]))(h, act)

        def level(i: int, h: torch.Tensor) -> torch.Tensor:
            s = None
            if skip_ch[i] != 0:
                s = conv_block(h, skip_ch[i], self.filter_skip_size)
                s = drop(norm(s, self.act_name))
            d = conv_block(h, self.filters[i], fs_down[i], stride=2, down_mode=down_modes[i])
            d = drop(norm(d, self.act_name))
            d = conv_block(d, self.filters[i], fs_down[i])
            d = drop(norm(d, self.act_name))
            if i < n - 1:
                d = level(i + 1, d)
            d = upsample(d, 2, up_modes[i])
            y = concat_crop([s, d]) if s is not None else d
            y = norm(y)
            y = conv_block(y, self.filters[i], fs_up[i])
            y = drop(norm(y, self.act_name))
            if self.need1x1_up:
                y = conv_block(y, self.filters[i], 1)
                y = drop(norm(y, self.act_name))
            return y

        x = level(0, x)
        x = conv_block(x, self.out_channels, 1)
        return self.last_act(x)
