"""The plain MulResUnet, 2D and 3D, as a function of a dict of parameters.

This is the benchmark's reference of the net that the configurations run. It
imports torch alone: every conv is ``F.conv2d``/``F.conv3d``, every Norm a
two-pass mean and variance, the x2 upsample ``F.interpolate``. It follows the
multi-resolution U-Net of polimi-ispl's ``deep_prior_interpolation``
(``architectures/mulresunet.py`` and ``mulresunet3d.py``):

* a multi-res block: three chained 3x3(x3) conv-Norm-LeakyReLU(0.2) of widths
  int(1.67u * 0.167), int(1.67u * 0.333) and int(1.67u * 0.5), concatenated, plus
  a 1x1(x1) conv-Norm-act shortcut of the summed width; in 3D a Norm after the
  concatenation and another after the residual add and its activation;
* a residual path: a 3x3 and a 1x1 conv-Norm-act added, activated and
  normalised (in 2D the Norm after the dropout, in 3D before it);
* each level: the residual path of the level's input, a stride-2 3x3 conv (in
  3D followed by a Norm), the activation, the encoder block, the deeper levels,
  a x2 upsample (nearest, or a half-pixel-centred linear resize), the centre
  crop and concatenation with the residual path, the decoder block;
* a 1x1 (2D) or 3x3x3 (3D) output conv with no activation.

Norm is a batch-of-1 batch norm without running statistics (eps 1e-5). Dropout
is left out: the configurations run with none.

Parameters are named as the parameters of the net under test are
(``MultiResBlock_0.ConvNormAct_0.Conv_0.kernel`` and so on, the Flax module
names of the published JAX port), so that one dict of weights made by the
benchmark goes to both. Kernels are (out, in, *window).

``quant`` computes the net in an emulated lower precision, the control of a
configuration (a precision below the one it states):

* ``"fp8"`` (below bfloat16): every tensor the net makes (the input, each
  conv's operands and output, each Norm, activation, sum, concatenation and
  upsample) rounded to float8 e4m3, and every gradient flowing back through
  those points to float8 e5m2, each with one scale per tensor, as a
  bfloat16 net rounds each of them to bfloat16;
* ``"tf32"`` (below float32 with TF32 off): each conv's operands, forward and
  backward, rounded to TF32's 10-bit mantissa, as tensor cores round them.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Spec = List[Tuple[str, Tuple[int, ...], str]]


def block_widths(u: int, alpha: float = 1.67) -> Tuple[int, int, int]:
    w = alpha * u
    return int(w * 0.167), int(w * 0.333), int(w * 0.5)


class _Q(torch.autograd.Function):
    """Round to ``fwd`` in the forward and the gradient to ``bwd`` in the
    backward (each a float8 dtype, "tf32", or None to pass through)."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return _round(x, fwd)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.bwd), None, None


_FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _round(x: torch.Tensor, fmt) -> torch.Tensor:
    if fmt is None:
        return x
    if fmt == "tf32":   # round to nearest on the 13 low mantissa bits
        bits = x.float().contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32).to(x.dtype)
    amax = x.detach().abs().amax()
    if not torch.isfinite(amax) or amax == 0:
        return x
    scale = _FP8_MAX[fmt] / amax
    return (x * scale).to(fmt).to(x.dtype) / scale


class MulResUnet:
    """The net of ``ndim`` spatial dims; ``spec()`` lists its parameters and
    ``__call__(params, x)`` runs it on an (N, C, *spatial) float tensor."""

    def __init__(self, in_channels: int, out_channels: int = 1, ndim: int = 3,
                 filters: Sequence[int] = (16, 32, 64, 128, 256),
                 skip: Sequence[int] = (16, 32, 64, 128), upsample: str = "nearest",
                 quant: Optional[str] = None):
        if len(filters) != len(skip) + 1:
            raise ValueError("filters must be one longer than skip")
        self.ndim, self.filters, self.skip = ndim, tuple(filters), tuple(skip)
        self.in_channels, self.out_channels = in_channels, out_channels
        self.linear = upsample not in ("nearest",)
        self.quant = quant
        self._spec: Spec = []
        self._counts: Dict[str, int] = {}
        self._build()

    # ---- parameters --------------------------------------------------
    def _name(self, kind: str) -> str:
        n = self._counts.get(kind, 0)
        self._counts[kind] = n + 1
        return f"{kind}_{n}"

    def _conv(self, prefix: str, cin: int, cout: int, k: int) -> None:
        self._spec.append((f"{prefix}.kernel", (cout, cin) + (k,) * self.ndim, "kernel"))
        self._spec.append((f"{prefix}.bias", (cout,), "bias"))

    def _norm(self, prefix: str, c: int) -> None:
        self._spec.append((f"{prefix}.scale", (c,), "scale"))
        self._spec.append((f"{prefix}.bias", (c,), "bias"))

    def _cna(self, prefix: str, cin: int, cout: int, k: int) -> None:
        self._conv(f"{prefix}.Conv_0", cin, cout, k)
        self._norm(f"{prefix}.Norm_0", cout)

    def _block(self, name: str, cin: int, u: int) -> int:
        c1, c2, c3 = block_widths(u)
        self._cna(f"{name}.ConvNormAct_0", cin, c1, 3)
        self._cna(f"{name}.ConvNormAct_1", c1, c2, 3)
        self._cna(f"{name}.ConvNormAct_2", c2, c3, 3)
        if self.ndim == 3:
            self._norm(f"{name}.Norm_0", c1 + c2 + c3)
        self._cna(f"{name}.ConvNormAct_3", cin, c1 + c2 + c3, 1)
        if self.ndim == 3:
            self._norm(f"{name}.Norm_1", c1 + c2 + c3)
        return c1 + c2 + c3

    def _build(self) -> None:
        self.block0 = self._name("MultiResBlock")
        c0 = self._block(self.block0, self.in_channels, self.filters[0])
        self.levels: Dict[int, Dict[str, Optional[str]]] = {}

        def level(i: int, c_h: int) -> int:
            names: Dict[str, Optional[str]] = {"path": None, "norm": None}
            if self.skip[i - 1]:
                names["path"] = self._name("ResPath")
                self._cna(f"{names['path']}.ConvNormAct_0", c_h, self.skip[i - 1], 3)
                self._cna(f"{names['path']}.ConvNormAct_1", c_h, self.skip[i - 1], 1)
                self._norm(f"{names['path']}.Norm_0", self.skip[i - 1])
            names["down"] = self._name("Conv")
            self._conv(names["down"], c_h, c_h, 3)
            if self.ndim == 3:
                names["norm"] = self._name("Norm")
                self._norm(names["norm"], c_h)
            names["enc"] = self._name("MultiResBlock")
            c_d = self._block(names["enc"], c_h, self.filters[i])
            if i < len(self.filters) - 1:
                c_d = level(i + 1, c_d)
            names["dec"] = self._name("MultiResBlock")
            c_out = self._block(names["dec"], c_d + self.skip[i - 1], self.filters[i - 1])
            self.levels[i] = names
            return c_out

        c = level(1, c0)
        self.head = self._name("Conv")
        self._conv(self.head, c, self.out_channels, 1 if self.ndim == 2 else 3)

    def spec(self) -> Spec:
        """(name, shape, kind) of every parameter; kind is kernel, bias or
        scale (a Norm's)."""
        return list(self._spec)

    # ---- forward -----------------------------------------------------
    def q(self, x: torch.Tensor) -> torch.Tensor:
        """A tensor the net makes, as the control's precision holds it."""
        if self.quant == "fp8":
            return _Q.apply(x, torch.float8_e4m3fn, torch.float8_e5m2)
        return x

    def conv(self, p: Dict[str, torch.Tensor], name: str, x: torch.Tensor,
             stride: int = 1) -> torch.Tensor:
        w = p[f"{name}.kernel"]
        k = w.shape[-1]
        if self.quant in ("fp8", "tf32"):
            fmt = "tf32" if self.quant == "tf32" else torch.float8_e4m3fn
            x, w = _Q.apply(x, fmt, None), _Q.apply(w, fmt, None)
        y = (F.conv2d, F.conv3d)[self.ndim - 2](x, w, stride=stride, padding=(k - 1) // 2)
        if self.quant in ("fp8", "tf32"):
            y = _Q.apply(y, None, "tf32" if self.quant == "tf32" else torch.float8_e5m2)
        return self.q(y + p[f"{name}.bias"].view((1, -1) + (1,) * self.ndim))

    def norm(self, p: Dict[str, torch.Tensor], name: str, x: torch.Tensor) -> torch.Tensor:
        axes = [0] + list(range(2, x.ndim))
        mean = x.mean(dim=axes, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=axes, keepdim=True)
        shape = (1, -1) + (1,) * self.ndim
        return self.q((x - mean) * torch.rsqrt(var + 1e-5) * p[f"{name}.scale"].view(shape)
                      + p[f"{name}.bias"].view(shape))

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return self.q(F.leaky_relu(x, 0.2))

    def cna(self, p, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.norm(p, f"{name}.Norm_0", self.conv(p, f"{name}.Conv_0", x)))

    def block(self, p, name: str, x: torch.Tensor) -> torch.Tensor:
        o1 = self.cna(p, f"{name}.ConvNormAct_0", x)
        o2 = self.cna(p, f"{name}.ConvNormAct_1", o1)
        o3 = self.cna(p, f"{name}.ConvNormAct_2", o2)
        out = self.q(torch.cat([o1, o2, o3], dim=1))
        if self.ndim == 3:
            out = self.norm(p, f"{name}.Norm_0", out)
        out = self.act(self.q(self.cna(p, f"{name}.ConvNormAct_3", x) + out))
        if self.ndim == 3:
            out = self.norm(p, f"{name}.Norm_1", out)
        return out

    def res_path(self, p, name: str, x: torch.Tensor) -> torch.Tensor:
        y = self.act(self.q(self.cna(p, f"{name}.ConvNormAct_0", x)
                            + self.cna(p, f"{name}.ConvNormAct_1", x)))
        return self.norm(p, f"{name}.Norm_0", y)

    def upsample(self, x: torch.Tensor) -> torch.Tensor:
        if self.linear:
            mode = "bilinear" if self.ndim == 2 else "trilinear"
            return self.q(F.interpolate(x, scale_factor=2, mode=mode, align_corners=False))
        return F.interpolate(x, scale_factor=2, mode="nearest")

    @staticmethod
    def crop_cat(xs: Sequence[torch.Tensor]) -> torch.Tensor:
        spatial = [min(x.shape[d] for x in xs) for d in range(2, xs[0].ndim)]
        out = []
        for x in xs:
            idx = [slice(None), slice(None)]
            for d, tgt in zip(x.shape[2:], spatial):
                lo = (d - tgt) // 2
                idx.append(slice(lo, lo + tgt))
            out.append(x[tuple(idx)])
        return torch.cat(out, dim=1)

    def _level(self, p, i: int, h: torch.Tensor) -> torch.Tensor:
        names = self.levels[i]
        s = self.res_path(p, names["path"], h) if names["path"] else None
        d = self.conv(p, names["down"], h, stride=2)
        if names["norm"]:
            d = self.norm(p, names["norm"], d)
        d = self.block(p, names["enc"], self.act(d))
        if i < len(self.filters) - 1:
            d = self._level(p, i + 1, d)
        d = self.upsample(d)
        y = self.q(self.crop_cat([s, d])) if s is not None else d
        return self.block(p, names["dec"], y)

    def __call__(self, p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        x = self.block(p, self.block0, self.q(x))
        x = self._level(p, 1, x)
        return self.conv(p, self.head, x)
