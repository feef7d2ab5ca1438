"""The Norm (batch-of-1 BatchNorm) and the LeakyReLU after it: a CUDA kernel
pair a direction for sm_90a, and their plain versions.

``models.blocks.Norm`` normalises over every axis but the channels with
float32 one-pass statistics (mean = s1/n, var = max(s2/n - mean^2, 0), g =
scale rsqrt(var + eps), b = bias - mean g) and applies x g + b; a
``ConvNormAct`` then applies its activation. ``norm_act_plain`` is that
arithmetic as tensor ops, moved here from ``Norm.forward`` as it was, with
LeakyReLU(0.2) after it where ``leaky``: the CPU path, every route that is
not the kernel's, and the yardstick of the tests.

``norm_act`` computes the same function with two kernels a direction
(``csrc/norm_act.cu``, compiled by ``ops/_build.py`` at first use): the
statistics, then z = act(x g + b) in float32 rounded once to x's dtype (the
tensor ops round x g and then + b); the backward's per-channel sums with the
pre-activation recomputed from x, then dx = g dy + c1 x + c0 in one pass. It
saves x in its own dtype and per-channel vectors, nothing else. No Pallas
kernel stands behind it: the Norm's passes are the largest share of the 3D
MulResUnet's step, in device time and in the host's dispatch (PERF.md).

``norm_act_forward`` and ``norm_act_backward`` are the two directions (two
launches each, counted on their ``.launches``; CUDA tensors only: the CPU
takes ``norm_act_plain``). ``norm_act_forward_lanes``
and ``norm_act_backward_lanes`` do B lanes (B, N, C, ...) in the same two
launches each, lane b with its own scale and bias and bit-identical to a
one-lane call on its input: ``norm_act_lanes`` takes them with autograd,
and ``norm_act`` under ``torch.func.vmap``, through its vmap rule.

``takes_kernel`` is the route ``Norm.forward`` takes: the kernels for a
plain CUDA tensor (no ``__torch_function__``: a list of spatial shards keeps
the tensor ops) of bfloat16 or float32, a Norm of phase 1; ``routes`` counts
the Norms on each route, and under ``fused`` those of the kernels' route
whose LeakyReLU ran inside them.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.overrides import has_torch_function

from . import _build

__all__ = ["norm_act", "norm_act_backward", "norm_act_backward_lanes", "norm_act_forward",
           "norm_act_forward_lanes", "norm_act_lanes", "norm_act_plain", "routes",
           "takes_kernel"]

SLOPE = 0.2       # LeakyReLU's negative slope, as models.blocks.get_activation has it
_THREADS = 256    # csrc/norm_act.cu: kThreads
_TARGET_BLOCKS = 1024
_MAX_UNITS = 16   # 16-byte units a thread at most
_STAT = 8         # floats a channel of the forward's statistics: g, b, mean, rstd, scale, keep

# Norms by route: "kernel", "plain"; "fused": the kernel's with LeakyReLU inside
routes: Dict[str, int] = collections.Counter()


def _bcast(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """(C,) -> (1, C, 1, ...) for an ndim-rank activation."""
    return v.view((1, -1) + (1,) * (ndim - 2))


def _lanes(v: torch.Tensor, b: int) -> torch.Tensor:
    """(C,) -> (C*b,), each entry ``b`` times in a row (a phase tensor's
    channels); its backward sums, with no atomics."""
    return v.unsqueeze(1).expand(-1, b).reshape(-1)


def norm_act_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-5, phase: int = 1, leaky: bool = False) -> torch.Tensor:
    """``Norm.forward``'s arithmetic as tensor ops, then LeakyReLU(0.2) where
    ``leaky``. ``phase > 1`` normalises a phase tensor, whose channel ``c``
    occupies ``phase`` consecutive channels."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    axes = [0] + list(range(2, x.ndim))
    s1 = torch.sum(xf, dim=axes)
    s2 = torch.sum(xf * xf, dim=axes)
    n = float(x.numel() // x.shape[1]) * phase
    if phase > 1:
        s1 = s1.view(-1, phase).sum(-1)
        s2 = s2.view(-1, phase).sum(-1)
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    g = scale * torch.rsqrt(var + eps)
    b = bias - mean * g
    if phase > 1:
        g, b = _lanes(g, phase), _lanes(b, phase)
    y = x * _bcast(g.to(x.dtype), x.ndim) + _bcast(b.to(x.dtype), x.ndim)
    return F.leaky_relu(y, negative_slope=SLOPE) if leaky else y


def takes_kernel(x: torch.Tensor, phase: int = 1) -> bool:
    """Does a Norm of ``phase`` take the kernels for ``x``?"""
    return (phase == 1 and not has_torch_function((x,)) and x.is_cuda
            and x.dtype in (torch.bfloat16, torch.float32) and x.numel() > 0)


# ----------------------------------------------------------------------
# the kernels
# ----------------------------------------------------------------------

@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("norm_act")
    # without argtypes ctypes would pass each pointer as a 32-bit int
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.dpi_norm_forward.argtypes = [p, p, ll, ll, ll, i, i, i, i, i, i, i, p, p, ll, f, p, p,
                                     p, p]
    lib.dpi_norm_backward.argtypes = [p, p, p, ll, ll, ll, ll, i, i, i, i, i, i, i, p, p, p, p,
                                      p, p, p]
    lib.dpi_norm_forward.restype = lib.dpi_norm_backward.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _parts(c: int, units: int) -> int:
    """Blocks a (lane, channel) of ``units`` units: up to ``_MAX_UNITS`` a
    thread, fewer while a lane's C channels would fill fewer than
    ``_TARGET_BLOCKS`` blocks. From C and the units alone, so a lane of a
    lane launch is split as a one-lane launch is."""
    k = _MAX_UNITS
    while k > 1 and c * -(-units // (_THREADS * k)) < _TARGET_BLOCKS:
        k //= 2
    return max(1, -(-units // (_THREADS * k)))


_scratch_of: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch(device: torch.device, stream: int, n_ws: int, n_ticket: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The workspace (float32 partials) and ticket counters of ``stream``,
    zeroed once and left at zero by every launch; a larger pair replaces them
    where a launch needs more."""
    key = (device.index, stream)
    ws, ticket = _scratch_of.get(key, (None, None))
    if ws is None or ws.numel() < n_ws or ticket.numel() < n_ticket:
        ws = torch.empty(max(n_ws, 1 << 16), dtype=torch.float32, device=device)
        ticket = torch.zeros(max(n_ticket, 1 << 12), dtype=torch.int32, device=device)
        _scratch_of[key] = (ws, ticket)
    return ws, ticket


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc}")


def _lane_major(t: torch.Tensor, lanes: int) -> Tuple[torch.Tensor, int]:
    """``t`` (lanes, ...) whose lanes are each contiguous, with its lane
    stride in elements (a contiguous copy where a lane is not)."""
    if t.is_contiguous():
        return t, t.numel() // lanes
    if lanes > 1 and t[0].is_contiguous():
        return t, t.stride(0)
    t = t.contiguous()
    return t, t.numel() // lanes


def _layout(name: str, x: torch.Tensor, batched: bool) -> Tuple[int, int, int, int]:
    """(lanes, N, C, S) of ``x``, (N, C, ...) or with ``batched`` (B, N, C,
    ...), after the checks the kernels need."""
    if not x.is_cuda:
        raise ValueError(f"{name} runs on a CUDA device, got {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name} takes bfloat16 or float32, got {x.dtype}")
    shape = x.shape[1:] if batched else x.shape
    if len(shape) < 2 or x.numel() == 0:
        raise ValueError(f"{name} takes non-empty (N, C, ...) lanes, got {tuple(x.shape)}")
    lanes = x.shape[0] if batched else 1
    n, c = shape[0], shape[1]
    return lanes, n, c, x.numel() // (lanes * n * c)


def _params(name: str, v: torch.Tensor, x: torch.Tensor, lanes: int, c: int
            ) -> Tuple[torch.Tensor, int]:
    """A float32 scale or bias of ``lanes`` x C on x's device, with its lane
    stride (0 where the lanes share it)."""
    if v.dtype != torch.float32 or v.device != x.device:
        raise TypeError(f"{name} takes float32 scale and bias on {x.device}, got {v.dtype} "
                        f"on {v.device}")
    if v.shape[-1] != c or v.numel() not in (c, lanes * c):
        raise ValueError(f"{name}: scale and bias of {c} channels a lane, got {tuple(v.shape)}")
    if v.dim() == 1 and v.is_contiguous():
        return v, 0
    if v.numel() == c:
        return v.reshape(c).contiguous(), 0
    if v.stride(-1) != 1:
        v = v.contiguous()
    return v, v.stride(0) if v.dim() > 1 else c


def _vec(s: int, elem: int, *tensors_and_strides) -> int:
    """1 where every channel of every lane starts on 16 bytes."""
    v = 16 // elem
    return int(s % v == 0 and all(t.data_ptr() % 16 == 0 and stride % v == 0
                                  for t, stride in tensors_and_strides))


def _forward_launch(name: str, x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float, leaky: bool, batched: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    lanes, n, c, s = _layout(name, x, batched)
    x, x_lane = _lane_major(x, lanes)
    scale, p_lane = _params(name, scale, x, lanes, c)
    bias, b_lane = _params(name, bias, x, lanes, c)
    if b_lane != p_lane:
        scale, bias = scale.expand(lanes, c).contiguous(), bias.expand(lanes, c).contiguous()
        p_lane = c
    z = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    stats = torch.empty(((lanes,) if batched else ()) + (c, _STAT), dtype=torch.float32,
                        device=x.device)
    vec = _vec(s, x.element_size(), (x, x_lane))
    p = _parts(c, s // (16 // x.element_size()) if vec else s)
    dev = x.device.index
    stream = torch._C._cuda_getCurrentRawStream(dev)
    ws, ticket = _scratch(x.device, stream, 2 * lanes * c * p, lanes * c)
    with _build.on_device(x.device):
        _check(_library().dpi_norm_forward(
            x.data_ptr(), z.data_ptr(), s, x_lane, x.numel() // lanes, n, c, lanes, p, vec,
            int(leaky), int(x.dtype == torch.bfloat16), scale.data_ptr(), bias.data_ptr(),
            p_lane, eps, ws.data_ptr(), ticket.data_ptr(), stats.data_ptr(), stream),
            f"{name}'s launch")
    return z, stats


def _backward_launch(name: str, x: torch.Tensor, dz: torch.Tensor, stats: torch.Tensor,
                     leaky: bool, batched: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    lanes, n, c, s = _layout(name, x, batched)
    if dz.shape != x.shape or dz.dtype != x.dtype or dz.device != x.device:
        raise ValueError(f"{name}: dz {tuple(dz.shape)} {dz.dtype} on {dz.device} against x "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")
    x, x_lane = _lane_major(x, lanes)
    dz, dz_lane = _lane_major(dz, lanes)
    stats = stats.contiguous()
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    out = torch.empty(6 * lanes * c, dtype=torch.float32, device=x.device)
    vec = _vec(s, x.element_size(), (x, x_lane), (dz, dz_lane))
    p = _parts(c, s // (16 // x.element_size()) if vec else s)
    dev = x.device.index
    stream = torch._C._cuda_getCurrentRawStream(dev)
    ws, ticket = _scratch(x.device, stream, 2 * lanes * c * p, lanes * c)
    coef, dscale, dbias = out.split([4 * lanes * c, lanes * c, lanes * c])
    with _build.on_device(x.device):
        _check(_library().dpi_norm_backward(
            x.data_ptr(), dz.data_ptr(), dx.data_ptr(), s, x_lane, dz_lane, x.numel() // lanes,
            n, c, lanes, p, vec, int(leaky), int(x.dtype == torch.bfloat16), stats.data_ptr(),
            ws.data_ptr(), ticket.data_ptr(), coef.data_ptr(), dscale.data_ptr(),
            dbias.data_ptr(), stream), f"{name}'s launch")
    shape = (lanes, c) if batched else (c,)
    return dx, dscale.view(shape), dbias.view(shape)


def norm_act_forward(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5, leaky: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(z, stats) of an (N, C, ...) CUDA x: z = act(Norm(x)) in x's dtype,
    stats (C, 8) float32 (g, b, mean, rstd, scale, keep, 0, 0). Two launches."""
    out = _forward_launch("norm_act_forward", x, scale, bias, eps, leaky, False)
    norm_act_forward.launches += 2
    return out


norm_act_forward.launches = 0


def norm_act_backward(x: torch.Tensor, dz: torch.Tensor, stats: torch.Tensor,
                      leaky: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dscale, dbias) of ``norm_act_forward`` from dz and its stats. Two
    launches."""
    out = _backward_launch("norm_act_backward", x, dz, stats, leaky, False)
    norm_act_backward.launches += 2
    return out


norm_act_backward.launches = 0


def norm_act_forward_lanes(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                           eps: float = 1e-5, leaky: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``norm_act_forward`` of each of the B lanes of a (B, N, C, ...) x, lane
    b with scale[b] and bias[b] ((B, C), or (C,) for every lane): (z, (B, C,
    8) stats). Two launches for all B lanes."""
    out = _forward_launch("norm_act_forward_lanes", x, scale, bias, eps, leaky, True)
    norm_act_forward_lanes.launches += 2
    return out


norm_act_forward_lanes.launches = 0


def norm_act_backward_lanes(x: torch.Tensor, dz: torch.Tensor, stats: torch.Tensor,
                            leaky: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``norm_act_backward`` of B lanes: (dx, (B, C) dscale, (B, C) dbias).
    Two launches for all B lanes."""
    out = _backward_launch("norm_act_backward_lanes", x, dz, stats, leaky, True)
    norm_act_backward_lanes.launches += 2
    return out


norm_act_backward_lanes.launches = 0


def _lane_first(t: torch.Tensor, dim: Optional[int], size: int) -> torch.Tensor:
    """A vmapped input with its lane dim first (an unbatched one repeated)."""
    return t.movedim(dim, 0) if dim is not None else t.expand((size,) + tuple(t.shape))


class _NormAct(torch.autograd.Function):
    """act(Norm(x)) of one lane, or of B lanes with ``lanes``, with its
    gradients: two launches a direction. Returns (z, stats), stats not
    differentiable. Under ``torch.func.vmap`` the vmap rule hands the lanes
    to the lane pair."""

    @staticmethod
    def forward(x, scale, bias, eps, leaky, lanes):
        return (norm_act_forward_lanes if lanes else norm_act_forward)(
            x, scale, bias, eps, leaky)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output[1])
        ctx.leaky, ctx.lanes = inputs[4], inputs[5]
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    def backward(ctx, dz, _dstats):
        x, stats = ctx.saved_tensors
        grads = (norm_act_backward_lanes if ctx.lanes else norm_act_backward)(
            x, dz, stats, ctx.leaky)
        return grads + (None, None, None)

    @staticmethod
    def vmap(info, in_dims, x, scale, bias, eps, leaky, lanes):
        if lanes:
            raise NotImplementedError("norm_act_lanes under vmap: vmap norm_act instead")
        b = info.batch_size
        x, scale, bias = (_lane_first(v, d, b) for v, d in zip((x, scale, bias), in_dims))
        return _NormAct.apply(x, scale, bias, eps, leaky, True), (0, 0)


def norm_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5,
             leaky: bool = False) -> torch.Tensor:
    """act(Norm(x)) of an (N, C, ...) CUDA x, differentiable in x, scale and
    bias: the kernel pair a direction; the lane pair under
    ``torch.func.vmap``."""
    return _NormAct.apply(x, scale, bias, eps, leaky, False)[0]


def norm_act_lanes(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-5, leaky: bool = False) -> torch.Tensor:
    """act(Norm(x)) of each lane of a (B, N, C, ...) CUDA x, lane b with
    scale[b] and bias[b]: two launches a direction for all B lanes."""
    return _NormAct.apply(x, scale, bias, eps, leaky, True)[0]
