"""NN building blocks (counterpart of ``models/blocks.py``), channels-first.

Activations are (N, C, *spatial) and conv kernels (O, I, *window), PyTorch's
own layout; ``io/bridge.py`` converts the JAX package's channels-last
parameters at the boundary. Parameter names follow the flax modules
(``Conv``: ``kernel``, ``bias``; ``Norm``: ``scale``, ``bias``) and child
modules carry flax's auto-names (``Conv_0``, ``Norm_0``, ...), so the bridge
is a name-for-name transpose.

* ``Norm`` is batch-of-1 BatchNorm without running statistics: normalise
  over all non-channel axes with float32 statistics (float64 ones for a
  float64 input), eps 1e-5; ``g`` and ``b`` are formed in float32 and
  applied in the input dtype.
* ``Conv`` pads (k-1)//2 on each side, so stride 2 gives ceil(n/2); the
  input and the float32 kernel are cast to the compute dtype, and the bias
  is added in that dtype. ``pad="reflection"`` reflects instead and
  convolves unpadded. ``phase_in``/``phase_out`` (and ``Norm(phase=B)``)
  run the same conv (and Norm) on phase tensors (``ops/phase_space.py``).
* ``upsample``: 'nearest' duplicates samples; any other mode is a
  half-pixel-centre linear resize (``align_corners=False``), whose backward
  by 2 is the gather of ``ops/upsample.py`` (a CUDA kernel on the card).
* ``Dropout`` is flax's, always on when rate > 0: each element is kept with
  probability 1 - rate and divided by 1 - rate. Its draws come from the
  explicit generator ``set_dropout_generator`` hands every Dropout of a net;
  a net run over lanes under ``torch.func.vmap`` (a batch of patches) is
  handed one generator a lane, and lane i's mask is the draw a net run alone
  on generator i makes.
* ``Compact`` is the base of the zoo nets: a child is made the first time
  ``forward`` asks for it, from the tensor it gets, and named as flax names
  the children of a compact module (``Conv_0``, ``Norm_3``, ...), so the
  forward reads like the flax module's ``__call__``.
* ``FlaxConv``, ``ConvTranspose`` and ``Dense`` are flax's ``nn.Conv``,
  ``nn.ConvTranspose`` and ``nn.Dense``: they compute in the promotion of
  the input's dtype and float32, and go to cuDNN and cuBLAS (never to the
  weight-gradient kernel, as the JAX package leaves them to XLA).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import phase_space as ps
from ..ops.conv_vjp import conv_same
from ..ops.upsample import linear_upsample2x


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


def _lanes(v: torch.Tensor, b: int) -> torch.Tensor:
    """(C,) -> (C*b,), each entry ``b`` times in a row (a phase tensor's
    channels); its backward sums, with no atomics."""
    return v.unsqueeze(1).expand(-1, b).reshape(-1)


class Norm(nn.Module):
    """Batch-of-1 BatchNorm: normalise over all non-channel axes.

    ``phase > 1`` normalises a phase tensor (``ops/phase_space.py``), whose
    channel ``c`` occupies ``phase`` consecutive channels: the per-channel
    sums are folded over those after the reduction and ``g``, ``b``
    repeated over them, so the result is the phase tensor of the plain
    Norm's."""

    def __init__(self, channels: int, eps: float = 1e-5, phase: int = 1):
        super().__init__()
        self.eps, self.phase = eps, phase
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(_promoted(x))
        axes = [0] + list(range(2, x.ndim))
        s1 = torch.sum(xf, dim=axes)
        s2 = torch.sum(xf * xf, dim=axes)
        n = float(x.numel() // x.shape[1]) * self.phase
        if self.phase > 1:
            s1 = s1.view(-1, self.phase).sum(-1)
            s2 = s2.view(-1, self.phase).sum(-1)
        mean = s1 / n
        var = torch.clamp(s2 / n - mean * mean, min=0.0)
        g = self.scale * torch.rsqrt(var + self.eps)
        b = self.bias - mean * g
        if self.phase > 1:
            g, b = _lanes(g, self.phase), _lanes(b, self.phase)
        return x * _bcast(g.to(x.dtype), x.ndim) + _bcast(b.to(x.dtype), x.ndim)


class Conv(nn.Module):
    """Same-pad conv (symmetric (k-1)//2 zero padding), 2D or 3D.

    ``dtype`` is the compute dtype (bfloat16 for the fast path); the
    parameters stay float32. The kernel is allocated as zeros and drawn by
    ``models.init.init_weights``.

    ``phase_in``/``phase_out`` run the same conv (same parameters) on phase
    tensors of depth ``phase_depth`` (``ops/phase_space.py``): plain ->
    phase at stride 1 (the fused entry conv), phase -> phase at stride 1
    (the swap-folded kernel), phase -> plain at stride 2 (the exit, whose
    output grid is the phase grid). The bias is repeated over the phase
    channels of a phase output.
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, ndim: int = 2, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None, pad: str = "zero",
                 phase_in: bool = False, phase_out: bool = False, phase_depth: int = 1):
        super().__init__()
        if (phase_in or phase_out) and pad != "zero":
            raise ValueError("a phase conv takes zero padding only")
        if (phase_out and stride != 1) or (phase_in and not phase_out and stride != 2):
            raise ValueError(f"phase_in={phase_in}, phase_out={phase_out} takes stride "
                             f"{1 if phase_out else 2}, got {stride}")
        self.kernel_size, self.stride, self.dtype = kernel_size, stride, dtype
        self.pad = pad
        self.phase_in, self.phase_out, self.phase_depth = phase_in, phase_out, phase_depth
        self.kernel = nn.Parameter(
            torch.zeros((features, in_channels) + (kernel_size,) * ndim))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype if self.dtype is not None else x.dtype
        p = (self.kernel_size - 1) // 2
        x, w = x.to(dt), self.kernel.to(dt)
        if self.phase_in or self.phase_out:
            if not self.phase_in:
                y = ps.phase_entry_conv(x, w, self.phase_depth)
            elif self.phase_out:
                y = ps.phase_conv(x, w, self.phase_depth)
            else:
                y = ps.phase_exit_conv(x, w, self.phase_depth)
            if self.bias is not None:
                b = self.bias.to(dt)
                if self.phase_out:
                    b = _lanes(b, 2 ** ((x.ndim - 2) * self.phase_depth))
                y = y + _bcast(b, y.ndim)
            return y
        if self.pad == "reflection" and p > 0:
            x, p = F.pad(x, (p, p) * (x.ndim - 2), mode="reflect"), 0
        y = conv_same(x, w, self.stride, p)
        if self.bias is not None:
            y = y + _bcast(self.bias.to(dt), y.ndim)
        return y


class ConvNormAct(nn.Module):
    """conv -> Norm -> activation; with ``phase_out`` the Norm of a phase
    tensor of depth ``phase_depth``."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, ndim: int = 2, use_bias: bool = True,
                 act: str = "LeakyReLU", dtype: Optional[torch.dtype] = None,
                 phase_in: bool = False, phase_out: bool = False, phase_depth: int = 1):
        super().__init__()
        self.Conv_0 = Conv(in_channels, features, kernel_size, stride, ndim,
                           use_bias, dtype=dtype, phase_in=phase_in, phase_out=phase_out,
                           phase_depth=phase_depth)
        self.Norm_0 = Norm(features, phase=2 ** (ndim * phase_depth) if phase_out else 1)
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
    'bilinear'/'trilinear'/'linear' is a half-pixel linear resize, by 2 in 2D
    and 3D through ``linear_upsample2x`` (its backward a gather in a fixed
    order, so a card run repeats bit for bit)."""
    ndim = x.ndim - 2
    if mode == "nearest":
        for ax in range(2, x.ndim):
            x = torch.repeat_interleave(x, factor, dim=ax)
        return x
    if factor == 2 and ndim in (2, 3):
        return linear_upsample2x(x)
    lin = {1: "linear", 2: "bilinear", 3: "trilinear"}[ndim]
    return F.interpolate(x, scale_factor=factor, mode=lin, align_corners=False)


def downsample_pool(x: torch.Tensor, factor: int, mode: str) -> torch.Tensor:
    """avg or max pooling of the spatial dims by ``factor`` (floor sizes)."""
    nd = x.ndim - 2
    pools = {"avg": (F.avg_pool1d, F.avg_pool2d, F.avg_pool3d),
             "max": (F.max_pool1d, F.max_pool2d, F.max_pool3d)}
    if mode not in pools:
        raise ValueError(f"unknown pooling mode '{mode}'")
    return pools[mode][nd - 1](x, factor, factor)


def symmetry(x: torch.Tensor, axes: Sequence[int] = (-2, -1)) -> torch.Tensor:
    """Symmetrise over two spatial dims: (x + x^T) / 2 (by default the last
    two, which are the JAX package's channels-last (-3, -2))."""
    return (x + torch.swapaxes(x, axes[0], axes[1])) / 2


def resample_kernel_1d(factor: int, kernel_type: str, support: Optional[int] = None,
                       sigma: Optional[float] = None) -> torch.Tensor:
    """1-D anti-aliasing taps, float32, unit sum: lanczos (half phase), box
    or gauss."""
    if kernel_type.startswith("lanczos"):
        support = support or int(kernel_type[-1]) if kernel_type[-1].isdigit() \
            else (support or 2)
        return lanczos_kernel_1d(factor, support)
    if kernel_type == "box":
        w = torch.ones((factor,), dtype=torch.float32)
        return w / torch.sum(w)
    if kernel_type.startswith("gauss"):
        sigma = sigma if sigma is not None else 0.5
        width = 2 * factor + 1
        n = torch.arange(width, dtype=torch.float32) - (width - 1) / 2.0
        w = torch.exp(-(n ** 2) / (2 * sigma * sigma))
        return w / torch.sum(w)
    raise ValueError(f"wrong resampling kernel name '{kernel_type}'")


def lanczos_kernel_1d(factor: int, support: int) -> torch.Tensor:
    """Half-phase Lanczos taps of width ``2 * support * factor``, float32,
    unit sum."""
    width = 2 * support * factor
    center = (width + 1) / 2.0
    i = torch.arange(1, width + 1, dtype=torch.float32)
    d = torch.abs(i + 0.5 - center) / factor
    val = torch.where(d == 0, torch.ones_like(d),
                      support * torch.sin(math.pi * d) * torch.sin(math.pi * d / support)
                      / (math.pi * math.pi * d * d))
    return val / torch.sum(val)


def lanczos_downsample(x: torch.Tensor, factor: int, support: int = 2) -> torch.Tensor:
    """Separable Lanczos anti-aliased downsample of the spatial dims of an
    (N, C, *spatial) tensor: per dim, edge padding and a stride-``factor``
    correlation with the 1-D taps."""
    taps = lanczos_kernel_1d(factor, support).to(x.device, x.dtype)
    width = taps.shape[0]
    pad = (width - factor) // 2
    for ax in range(2, x.ndim):
        xm = x.movedim(ax, -1)
        lead = xm.shape[:-1]
        xr = F.pad(xm.reshape(-1, 1, xm.shape[-1]), (pad, pad), mode="replicate")
        y = F.conv1d(xr, taps.view(1, 1, width), stride=factor)
        x = y.reshape(lead + (y.shape[-1],)).movedim(-1, ax)
    return x


class _LaneUniform(torch.autograd.Function):
    """Uniform float32 draws of x's shape under ``torch.func.vmap``, lane i's
    from ``generators[i]``: the vmap rule draws lane by lane, so each lane
    draws what an unbatched call on its generator draws."""

    @staticmethod
    def forward(x, generators):
        raise RuntimeError("one generator a lane draws only under torch.func.vmap; an "
                           "unbatched net takes one generator")

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return None, None

    @staticmethod
    def vmap(info, in_dims, x, generators):
        if len(generators) != info.batch_size:
            raise ValueError(f"{len(generators)} dropout generators for "
                             f"{info.batch_size} lanes")
        x = x.movedim(in_dims[0], 0)
        return torch.stack([torch.rand(x.shape[1:], generator=g, device=x.device)
                            for g in generators]), 0


class Dropout(nn.Module):
    """flax ``nn.Dropout`` (always on when rate > 0): keep each element with
    probability 1 - rate, a uniform float32 draw from ``generator`` below
    1 - rate, and divide the kept ones by 1 - rate. ``generator`` may be a
    list, one a lane of a ``torch.func.vmap``."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: Union[torch.Generator, Sequence[torch.Generator], None] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate <= 0.0 or Compact.building:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        if self.generator is None or isinstance(self.generator, torch.Generator):
            return self.keep(x, self.draw(x.shape, x.device))
        return self.keep(x, _LaneUniform.apply(x, tuple(self.generator)) < 1.0 - self.rate)

    def draw(self, shape: Sequence[int], device=None) -> torch.Tensor:
        """One keep mask of ``shape`` on ``device`` (the generator's by
        default): a uniform float32 draw from ``generator`` below 1 - rate."""
        if self.generator is None:
            raise RuntimeError("dropout > 0 draws from an explicit generator: "
                               "call set_dropout_generator(model, generator) first")
        return torch.rand(tuple(shape), generator=self.generator,
                          device=device or self.generator.device) < 1.0 - self.rate

    def keep(self, x: torch.Tensor, kept: torch.Tensor) -> torch.Tensor:
        """``x / (1 - rate)`` where ``kept``, zeros elsewhere."""
        keep = 1.0 - self.rate
        return torch.where(kept, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def set_dropout_generator(model: nn.Module,
                          generator: Union[torch.Generator, Sequence[torch.Generator], None]
                          ) -> None:
    """Hand ``generator`` (or one generator a lane) to every Dropout of
    ``model``."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class Compact(nn.Module):
    """Base of a module whose children are made where ``forward`` first asks
    for them (``child``), named as flax names the children of a compact
    module: ``<kind>_<n>``, numbered per kind in call order. ``build`` runs
    that first forward on a small zero input on the CPU; later calls ask for
    the same children in the same order."""

    building = False  # a build pass runs: Dropout passes its input through

    def __init__(self):
        super().__init__()
        self._order: List[str] = []
        self._counts: Dict[str, int] = {}
        self._built = False
        self._next = 0

    def child(self, kind: str, make: Callable[[], nn.Module],
              name: Optional[str] = None) -> nn.Module:
        if not self._built:
            if name is None:
                name = f"{kind}_{self._counts.get(kind, 0)}"
                self._counts[kind] = self._counts.get(kind, 0) + 1
            self.add_module(name, make())
            self._order.append(name)
        else:
            name = self._order[self._next]
            self._next += 1
        return getattr(self, name)

    def __call__(self, *args, **kwargs):
        self._next = 0
        out = super().__call__(*args, **kwargs)
        self._built = True
        return out

    def build(self, *inputs: torch.Tensor) -> "Compact":
        """Make every child with one forward on ``inputs`` (no gradient)."""
        Compact.building = True
        try:
            with torch.no_grad():
                self(*inputs)
        finally:
            Compact.building = False
        return self


def _promoted(x: torch.Tensor) -> torch.dtype:
    """flax's ``promote_dtype`` of an input and a float32 parameter."""
    return torch.promote_types(x.dtype, torch.float32)


class FlaxConv(nn.Module):
    """flax ``nn.Conv``: symmetric zero padding (k-1)//2, no same-pad gate,
    computed in the promotion of the input's dtype and float32 (cuDNN).
    ``init`` names the flax initialiser of its kernel ('lecun' for
    ``lecun_normal``, 'kaiming' for ``kaiming_normal``, 'orthogonal'), which
    ``init_weights`` draws for ``inittype='default'``."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, ndim: int = 2, use_bias: bool = True,
                 init: str = "lecun"):
        super().__init__()
        self.stride, self.padding = stride, (kernel_size - 1) // 2
        self.kernel = nn.Parameter(
            torch.zeros((features, in_channels) + (kernel_size,) * ndim))
        self.kernel_init = init
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _promoted(x)
        conv = (F.conv1d, F.conv2d, F.conv3d)[self.kernel.ndim - 3]
        return conv(x.to(dt), self.kernel.to(dt),
                    None if self.bias is None else self.bias.to(dt),
                    stride=self.stride, padding=self.padding)


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose`` with ``padding='SAME'`` (output = stride x
    input). The kernel is PyTorch's (in, out, *window), applied flipped;
    the bridge flips flax's (*window, in, out) kernel into it."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 4,
                 stride: int = 2, ndim: int = 2, use_bias: bool = True):
        super().__init__()
        k, s = kernel_size, stride
        # lax.conv_transpose's SAME padding of the dilated input: (a, b)
        pad_len = k + s - 2
        a = k - 1 if s > k - 1 else int(math.ceil(pad_len / 2))
        self.stride, self.padding = s, k - 1 - a
        self.output_padding = (pad_len - a) - a
        if self.output_padding < 0:
            raise ValueError(f"ConvTranspose: k={k}, stride={s} is not supported")
        self.kernel = nn.Parameter(
            torch.zeros((in_channels, features) + (kernel_size,) * ndim))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _promoted(x)
        conv_t = (F.conv_transpose1d, F.conv_transpose2d,
                  F.conv_transpose3d)[self.kernel.ndim - 3]
        return conv_t(x.to(dt), self.kernel.to(dt),
                      None if self.bias is None else self.bias.to(dt),
                      stride=self.stride, padding=self.padding,
                      output_padding=self.output_padding)


class Dense(nn.Module):
    """flax ``nn.Dense`` on the last dim. The kernel is PyTorch's (out, in);
    the bridge transposes flax's (in, out)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros((features, in_features)))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _promoted(x)
        return F.linear(x.to(dt), self.kernel.to(dt),
                        None if self.bias is None else self.bias.to(dt))
