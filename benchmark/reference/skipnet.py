"""The plain Deep-Image-Prior skip net, 2D and 3D, as a function of a dict of
parameters.

This is the benchmark's reference of the ``skip3d`` configuration. It imports
torch alone: every conv is ``F.conv2d``/``F.conv3d``, every Norm a two-pass
mean and variance, the x2 upsample ``F.interpolate``, the skip join
``torch.cat``. It follows ``skip()`` of Ulyanov, Vedaldi and Lempitsky's
``deep-image-prior`` (``models/skip.py``), as its notebooks build it through
``get_net(32, 'skip', pad, skip_n33d=128, skip_n33u=128, skip_n11=4,
num_scales=5, upsample_mode='bilinear')``, and the 3D form of polimi-ispl's
``architectures/skip.py`` (``Skip3D``). Level i of n, from its input h:

* the skip branch (where its width is not 0): a 1x1(x1) conv, Norm, act;
* the deeper path: a stride-2 conv, Norm, act, then a conv, Norm, act, the
  levels below (but at the last), a x2 upsample;
* the centre crop of both to the smaller and their concatenation (skip
  first), a Norm;
* the up conv, Norm, act; a 1x1(x1) conv, Norm, act (``need1x1_up``).

After level 0 a final 1x1(x1) conv. Convs are 3x3(x3) but where named,
same-padded, with biases; act is LeakyReLU(0.2); Norm is a batch-of-1 batch
norm without running statistics (eps 1e-5), as DIP's ``BatchNorm`` in
training mode. ``skip`` is padded with its last width (4 where empty) to the
length of ``filters``, as the port pads it.

Departures from DIP, each also listed under ``assumed`` in
``configs/skip3d.json``:

* zero padding, not ``pad='reflection'`` (the factories of the JAX package
  and of the port pass no ``pad``);
* no final sigmoid (``need_sigmoid``): seismic amplitudes are signed, and
  polimi-ispl's configurations leave the last activation out;
* a half-pixel-centred trilinear upsample in 3D for DIP's bilinear;
* one list of widths for both paths (DIP's ``num_channels_down`` and
  ``num_channels_up`` are equal in the published net); no dropout.

Parameters are named as the parameters of the port's ``SkipNet`` are
(``Conv_0.kernel``, ``Norm_0.scale`` and so on, numbered in the order its
forward first calls each child), so that one dict of weights made by the
benchmark goes to both. Kernels are (out, in, *window).

``quant`` computes the net in an emulated lower precision, as
``mulresunet.py`` does (``"fp8"`` below bfloat16, ``"tf32"`` below float32).

The Norm keeps one full-size tensor for its backward (x - mean); its scale
is folded into the per-channel factor before it meets the activation, so
the float64 step that the comparison takes at the published widths fits on
one card.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from .mulresunet import MulResUnet as _MulResUnet


class SkipNet(_MulResUnet):
    """The net of ``ndim`` spatial dims; ``spec()`` lists its parameters and
    ``__call__(params, x)`` runs it on an (N, C, *spatial) float tensor. The
    conv, activation, upsample, crop and precision control are the
    MulResUnet reference's."""

    def __init__(self, in_channels: int, out_channels: int = 1, ndim: int = 3,
                 filters: Sequence[int] = (128, 128, 128, 128, 128),
                 skip: Sequence[int] = (4, 4, 4, 4, 4), upsample: str = "nearest",
                 quant: Optional[str] = None):
        skip = list(skip)
        while len(skip) < len(filters):
            skip.append(skip[-1] if skip else 4)
        self.ndim, self.filters, self.skip = ndim, tuple(filters), tuple(skip)
        self.in_channels, self.out_channels = in_channels, out_channels
        self.linear = upsample not in ("nearest",)
        self.quant = quant
        self._spec = []
        self._counts: Dict[str, int] = {}
        self._build()

    def _build(self) -> None:
        self.levels: List[Dict[str, Optional[str]]] = []

        def conv(cin: int, cout: int, k: int) -> str:
            name = self._name("Conv")
            self._conv(name, cin, cout, k)
            return name

        def norm(c: int) -> str:
            name = self._name("Norm")
            self._norm(name, c)
            return name

        def level(i: int, c_in: int) -> int:
            f, s = self.filters[i], self.skip[i]
            names: Dict[str, Optional[str]] = {"skip": None, "skip_norm": None}
            if s:
                names["skip"], names["skip_norm"] = conv(c_in, s, 1), norm(s)
            names["down"], names["down_norm"] = conv(c_in, f, 3), norm(f)
            names["conv"], names["conv_norm"] = conv(f, f, 3), norm(f)
            self.levels.append(names)
            c_d = level(i + 1, f) if i < len(self.filters) - 1 else f
            names["cat_norm"] = norm(s + c_d)
            names["up"], names["up_norm"] = conv(s + c_d, f, 3), norm(f)
            names["mix"], names["mix_norm"] = conv(f, f, 1), norm(f)
            return f

        c = level(0, self.in_channels)
        self.head = conv(c, self.out_channels, 1)

    # ---- forward -----------------------------------------------------
    def norm(self, p: Dict[str, torch.Tensor], name: str, x: torch.Tensor) -> torch.Tensor:
        axes = [0] + list(range(2, x.ndim))
        xc = x - x.mean(dim=axes, keepdim=True)
        var = (xc * xc).mean(dim=axes, keepdim=True)
        shape = (1, -1) + (1,) * self.ndim
        g = torch.rsqrt(var + 1e-5) * p[f"{name}.scale"].view(shape)
        return self.q(xc * g + p[f"{name}.bias"].view(shape))

    def _level(self, p, i: int, h: torch.Tensor) -> torch.Tensor:
        names = self.levels[i]
        s = None
        if names["skip"]:
            s = self.act(self.norm(p, names["skip_norm"], self.conv(p, names["skip"], h)))
        d = self.act(self.norm(p, names["down_norm"], self.conv(p, names["down"], h, 2)))
        d = self.act(self.norm(p, names["conv_norm"], self.conv(p, names["conv"], d)))
        if i < len(self.filters) - 1:
            d = self._level(p, i + 1, d)
        d = self.upsample(d)
        y = self.q(self.crop_cat([s, d])) if s is not None else d
        y = self.norm(p, names["cat_norm"], y)
        y = self.act(self.norm(p, names["up_norm"], self.conv(p, names["up"], y)))
        return self.act(self.norm(p, names["mix_norm"], self.conv(p, names["mix"], y)))

    def __call__(self, p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        return self.conv(p, self.head, self._level(p, 0, self.q(x)))


# ``benchmark/harness.py`` builds a configuration's reference as the class
# ``MulResUnet`` of the module its ``reference`` names; this is that name here
MulResUnet = SkipNet
