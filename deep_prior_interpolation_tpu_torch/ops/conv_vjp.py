"""Zero-padded convolution whose weight gradient can run on the wgrad kernel.

Counterpart of ``ops/conv_vjp.py``'s ``conv_same``. The forward conv and
the data gradient stay on cuDNN (``F.conv2d``/``F.conv3d`` and
``torch.nn.grad.conv*_input``), as the JAX package leaves them to XLA.
The weight gradient, in the JAX package's order:

1. the hand-written kernel of ``ops/wgrad.py`` when ``DPI_PALLAS_WGRAD=1``
   (the JAX package's own switch) and ``wgrad_supported`` admits the conv;
2. with ``DPI_PACKED_WGRAD=1``, when ``_use_packed`` says so, the packed
   form: one padded copy of dy a kernel tap, concatenated, and one float32
   matrix product a group of taps (``DPI_WGRAD_CAP_MB`` caps a group's
   canvas); a strided conv only with ``DPI_FOLD_WGRAD=1``, folded by its
   stride (space-to-depth) into a stride-1 one first;
3. else ``torch.nn.grad.conv*_weight``.

Every switch is read when the backward runs. dW is returned in the
weight's dtype, so a bf16 net rounds a float32 sum to bf16, as the JAX
package does.

``conv_impl("tapmm")`` selects another formulation of the conv itself:
the sum of one matrix product a kernel tap, each in float32, rounded once
at the end. A conv records the formulation it ran under and its backward
takes the same one, also when autograd runs it on another thread (as it
does for CUDA tensors) or a remat recomputes it.

Under ``torch.func.vmap`` (a batch of patches, each with its own weights:
``parallel/mesh.py``) the conv's vmap rule runs B lanes at once, as the JAX
package's ``vmap`` does: x (B, N, C, *sp) and w (B, O, I, *k). "conv" is a
grouped cuDNN conv over (N, B*C, *sp) with ``groups=B`` (the JAX package's
"grouped" lowering), its dx the grouped transpose; dW goes to the wgrad
kernel's lane launch (``wgrad3d_lanes``) where the gate admits the lane's
conv, else per lane to the packed or folded form, else to the grouped
library weight gradient. "tapmm" takes one batched float32 product a tap.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import os
import threading
from typing import Iterator, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from .wgrad import wgrad3d, wgrad3d_lanes, wgrad_supported

__all__ = ["conv_same", "conv_impl", "current_conv_impl", "use_wgrad_kernel"]

_FWD = {2: F.conv2d, 3: F.conv3d}
_DX = {2: torch.nn.grad.conv2d_input, 3: torch.nn.grad.conv3d_input}
_DW = {2: torch.nn.grad.conv2d_weight, 3: torch.nn.grad.conv3d_weight}

Pads = Tuple[Tuple[int, int], ...]
Padding = Union[int, Sequence[Tuple[int, int]]]

# the conv formulation of the calling thread, switched by conv_impl
_IMPL_TLS = threading.local()


def current_conv_impl() -> str:
    return getattr(_IMPL_TLS, "mode", "conv")


@contextlib.contextmanager
def conv_impl(mode: str) -> Iterator[None]:
    """Run the convs called inside the context as ``mode``: "conv" (cuDNN,
    the default) or "tapmm" (a float32 matrix product a kernel tap). The
    mode is the calling thread's; the solver enters it around its step."""
    if mode not in ("conv", "tapmm"):
        raise ValueError(f"conv_impl takes 'conv' or 'tapmm', got {mode!r}")
    prev = current_conv_impl()
    _IMPL_TLS.mode = mode
    try:
        yield
    finally:
        _IMPL_TLS.mode = prev


def _pairs(padding: Padding, nd: int) -> Pads:
    if isinstance(padding, int):
        return ((padding, padding),) * nd
    return tuple((int(p[0]), int(p[1])) for p in padding)


def _flat(pads: Pads) -> Tuple[int, ...]:
    """``F.pad``'s argument: the last dim first."""
    return tuple(v for lo_hi in reversed(pads) for v in lo_hi)


def _taps(ks: Sequence[int]):
    return itertools.product(*[range(k) for k in ks])


def _tap_slice(t: Sequence[int], out_sp: Sequence[int], stride: int) -> tuple:
    """The positions of the padded input that tap ``t`` multiplies."""
    return (slice(None), slice(None)) + tuple(
        slice(t[i], t[i] + (out_sp[i] - 1) * stride + 1, stride) for i in range(len(t)))


def _tap_conv(x: torch.Tensor, w: torch.Tensor, stride: int, pads: Pads) -> torch.Tensor:
    """The conv as a sum of k^d per-tap matrix products, each in float32
    (bf16 products are exact there), rounded to ``x``'s dtype once."""
    n, ci = x.shape[:2]
    co, ks = w.shape[0], w.shape[2:]
    xp = F.pad(x, _flat(pads))
    out_sp = [(xp.shape[2 + i] - ks[i]) // stride + 1 for i in range(len(ks))]
    wf = w.float()
    acc = None
    for t in _taps(ks):
        xs = xp[_tap_slice(t, out_sp, stride)].float().reshape(n, ci, -1)
        c = torch.matmul(wf[(slice(None), slice(None)) + t], xs)
        acc = c if acc is None else acc + c
    return acc.reshape([n, co] + out_sp).to(x.dtype)


def _tap_conv_input(dy: torch.Tensor, w: torch.Tensor, x_shape, stride: int,
                    pads: Pads) -> torch.Tensor:
    """dx of :func:`_tap_conv` in float32: each tap's transposed product
    added into a padded canvas, in tap order, then cropped."""
    n, co, *out_sp = dy.shape
    ci, ks = w.shape[1], w.shape[2:]
    dxp = dy.new_zeros([n, ci] + [x_shape[2 + i] + sum(pads[i]) for i in range(len(ks))],
                       dtype=torch.float32)
    dyf = dy.float().reshape(n, co, -1)
    wf = w.float()
    for t in _taps(ks):
        dxp[_tap_slice(t, out_sp, stride)] += torch.matmul(
            wf[(slice(None), slice(None)) + t].t(), dyf).reshape([n, ci] + out_sp)
    crop = (slice(None), slice(None)) + tuple(
        slice(pads[i][0], pads[i][0] + x_shape[2 + i]) for i in range(len(ks)))
    return dxp[crop]


def _tap_conv_weight(x: torch.Tensor, dy: torch.Tensor, w_shape, stride: int,
                     pads: Pads) -> torch.Tensor:
    """dW of :func:`_tap_conv` in float32: a product a tap."""
    n, co, *out_sp = dy.shape
    ci = x.shape[1]
    xp = F.pad(x, _flat(pads))
    dyf = dy.float().reshape(n, co, -1)
    cols = []
    for t in _taps(w_shape[2:]):
        xs = xp[_tap_slice(t, out_sp, stride)].float().reshape(n, ci, -1)
        cols.append(torch.matmul(dyf, xs.transpose(1, 2)).sum(0))
    return torch.stack(cols, -1).reshape(w_shape)


def _tap_groups(n_taps: int, nu: int, co: int, itemsize: int) -> Tuple[int, int]:
    """(taps a group, groups) so a group's canvas of ``nu`` x ``co`` values
    a tap stays under ``DPI_WGRAD_CAP_MB`` (default 512)."""
    cap = int(os.environ.get("DPI_WGRAD_CAP_MB", "512")) << 20
    per_tap = nu * co * itemsize
    g = max(1, min(n_taps, cap // max(per_tap, 1)))
    return g, -(-n_taps // g)


def _packed_wgrad(x: torch.Tensor, dy: torch.Tensor, w_shape, stride: int,
                  pads: Pads) -> torch.Tensor:
    """dW of a stride-1 conv, float32: dy placed into a zero canvas of the
    padded input's size once a tap (at the tap's offset), the canvases of a
    group of taps concatenated, and one product a group,
    ``dW[co, ci, t] = sum_u xp[ci, u] canvas_t[co, u]``."""
    if stride != 1:
        raise ValueError("the packed weight gradient takes stride 1; fold first")
    co, ci, ks = w_shape[0], w_shape[1], tuple(w_shape[2:])
    xp = F.pad(x, _flat(pads))
    U = xp.shape[2:]
    S = dy.shape[2:]
    n = x.shape[0]
    nu = n * math.prod(U)
    xf = xp.transpose(0, 1).reshape(ci, nu).float()
    taps = list(_taps(ks))
    g, _ = _tap_groups(len(taps), nu, co, dy.element_size())
    outs = []
    for i in range(0, len(taps), g):
        parts = []
        for t in taps[i:i + g]:
            spec = []
            for ax in reversed(range(len(ks))):
                spec += [t[ax], U[ax] - S[ax] - t[ax]]
            parts.append(F.pad(dy, spec).transpose(0, 1).reshape(co, nu))
        canvas = torch.cat(parts, 0).float()                   # (g * Co, nu)
        outs.append(torch.matmul(canvas, xf.t()).reshape(-1, co, ci))
    dw = torch.cat(outs, 0)                                    # (taps, Co, Ci)
    return dw.permute(1, 2, 0).reshape(w_shape)


def _fold_sizes(x_sp, k: int, s: int, pads: Pads, s_out) -> Tuple[int, ...]:
    """The folded grid: each dim of the padded input in blocks of ``s``,
    enough for the ceil(k/s) folded taps over the output."""
    a = -(-k // s)
    U = [x_sp[i] + sum(pads[i]) for i in range(len(x_sp))]
    return tuple(max(s_out[i] + a - 1, -(-U[i] // s)) for i in range(len(x_sp)))


def _folded_wgrad(x: torch.Tensor, dy: torch.Tensor, w_shape, stride: int,
                  pads: Pads) -> torch.Tensor:
    """dW of a stride-s conv: fold the padded input by s (space-to-depth:
    ceil(k/s)^d taps, s^d times the channels), take the stride-1 packed dW
    of the folded conv, and put its (a, phi) taps back at t = a*s + phi."""
    d = len(w_shape) - 2
    co, ci, k = w_shape[0], w_shape[1], w_shape[2]
    s = stride
    a = -(-k // s)
    n = x.shape[0]
    M = _fold_sizes(x.shape[2:], k, s, pads, dy.shape[2:])
    xp = F.pad(x, _flat(pads))
    U = xp.shape[2:]
    xp = F.pad(xp, _flat(tuple((0, s * M[i] - U[i]) for i in range(d))))
    shp = [n, ci]
    for m in M:
        shp += [m, s]
    perm = [0, 1] + [3 + 2 * i for i in range(d)] + [2 + 2 * i for i in range(d)]
    xs = xp.reshape(shp).permute(perm).reshape([n, ci * s ** d] + list(M))
    G = _packed_wgrad(xs, dy, (co, ci * s ** d) + (a,) * d, 1, ((0, 0),) * d)
    G = G.reshape([co, ci] + [s] * d + [a] * d)                # (Co, Ci, phi.., a..)
    perm = [0, 1]
    for j in range(d):
        perm += [2 + d + j, 2 + j]
    G = G.permute(perm).reshape([co, ci] + [a * s] * d)
    return G[(slice(None), slice(None)) + (slice(0, k),) * d]


def _use_packed(x_shape, w_shape, stride: int, pads: Pads, itemsize: int) -> bool:
    """With ``DPI_PACKED_WGRAD=1``: the packed dW when its canvases fit in
    at most 4 groups of taps (a strided conv only with ``DPI_FOLD_WGRAD=1``);
    the JAX package's gate, on the port's layout."""
    if os.environ.get("DPI_PACKED_WGRAD", "0") != "1":
        return False
    d = len(w_shape) - 2
    k = w_shape[2]
    if stride > 1 and os.environ.get("DPI_FOLD_WGRAD", "0") != "1":
        return False
    if stride == 1:
        taps = math.prod(w_shape[2:])
        nu = x_shape[0] * math.prod(x_shape[2 + i] + sum(pads[i]) for i in range(d))
    else:
        U = [x_shape[2 + i] + sum(pads[i]) for i in range(d)]
        s_out = [(U[i] - k) // stride + 1 for i in range(d)]
        taps = (-(-k // stride)) ** d
        nu = x_shape[0] * math.prod(_fold_sizes(x_shape[2:], k, stride, pads, s_out))
    _, ngroups = _tap_groups(taps, nu, w_shape[0], itemsize)
    return ngroups <= 4


def use_wgrad_kernel(x_shape, w_shape, stride: int, padding: Padding) -> bool:
    """Does the weight gradient of this conv go to the wgrad kernel?"""
    if os.environ.get("DPI_PALLAS_WGRAD", "0") != "1":
        return False
    return wgrad_supported(tuple(x_shape), tuple(w_shape), stride, padding)


def _symmetric(pads: Pads) -> bool:
    return all(lo == hi for lo, hi in pads)


class _ConvSame(torch.autograd.Function):
    @staticmethod
    def forward(x, w, stride, pads, mode):
        if mode == "tapmm":
            return _tap_conv(x, w, stride, pads)
        conv = _FWD[w.ndim - 2]
        if _symmetric(pads):
            return conv(x, w, stride=stride, padding=tuple(lo for lo, _ in pads))
        return conv(F.pad(x, _flat(pads)), w, stride=stride)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, ctx.stride, ctx.pads, ctx.mode = inputs
        ctx.save_for_backward(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        nd = w.ndim - 2
        stride, pads, tap = ctx.stride, ctx.pads, ctx.mode == "tapmm"
        sym = _symmetric(pads)
        padding = tuple(lo for lo, _ in pads)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            if tap:
                dx = _tap_conv_input(dy, w, x.shape, stride, pads).to(x.dtype)
            elif sym:
                dx = _DX[nd](x.shape, w, dy, stride=stride, padding=padding)
            else:
                xp_shape = x.shape[:2] + tuple(x.shape[2 + i] + lo + hi
                                               for i, (lo, hi) in enumerate(pads))
                dxp = _DX[nd](xp_shape, w, dy, stride=stride)
                dx = dxp[(slice(None), slice(None)) + tuple(
                    slice(lo, lo + x.shape[2 + i]) for i, (lo, _) in enumerate(pads))]
        if ctx.needs_input_grad[1]:
            if use_wgrad_kernel(x.shape, w.shape, stride, pads):
                dw = wgrad3d(x, dy, w.shape[2]).to(w.dtype)
            elif _use_packed(x.shape, w.shape, stride, pads, x.element_size()):
                wg = _packed_wgrad if stride == 1 else _folded_wgrad
                dw = wg(x, dy, tuple(w.shape), stride, pads).to(w.dtype)
            elif tap:
                dw = _tap_conv_weight(x, dy, tuple(w.shape), stride, pads).to(w.dtype)
            elif sym:
                dw = _DW[nd](x, w.shape, dy, stride=stride, padding=padding)
            else:
                dw = _DW[nd](F.pad(x, _flat(pads)), w.shape, dy, stride=stride)
        return dx, dw, None, None, None

    @staticmethod
    def vmap(info, in_dims, x, w, stride, pads, mode):
        b = info.batch_size
        x, w = (v.movedim(d, 0) if d is not None else v.expand((b,) + tuple(v.shape))
                for v, d in zip((x, w), in_dims[:2]))
        return _ConvSameLanes.apply(x, w, stride, pads, mode), 0


def _tap_lanes(x: torch.Tensor, ks: Sequence[int], stride: int, pads: Pads):
    """The padded lane input (B, N, C, *sp_p), the output grid and the taps."""
    b, n = x.shape[:2]
    xp = F.pad(x.reshape((b * n,) + tuple(x.shape[2:])), _flat(pads))
    xp = xp.reshape((b, n) + tuple(xp.shape[1:]))
    out_sp = [(xp.shape[3 + i] - ks[i]) // stride + 1 for i in range(len(ks))]
    return xp, out_sp, list(_taps(ks))


def _lane_slice(t, out_sp, stride) -> tuple:
    return (slice(None),) + _tap_slice(t, out_sp, stride)


def _tap_conv_lanes(x: torch.Tensor, w: torch.Tensor, stride: int, pads: Pads) -> torch.Tensor:
    """:func:`_tap_conv` of B lanes: one batched float32 product a tap."""
    b, n, ci = x.shape[:3]
    co = w.shape[1]
    xp, out_sp, taps = _tap_lanes(x, w.shape[3:], stride, pads)
    wf = w.float()
    acc = None
    for t in taps:
        xs = xp[_lane_slice(t, out_sp, stride)].float().reshape(b, n, ci, -1)
        c = torch.matmul(wf[(slice(None),) * 3 + t].unsqueeze(1), xs)   # (B, N, O, S)
        acc = c if acc is None else acc + c
    return acc.reshape([b, n, co] + out_sp).to(x.dtype)


def _tap_conv_input_lanes(dy, w, x_shape, stride: int, pads: Pads) -> torch.Tensor:
    """:func:`_tap_conv_input` of B lanes, float32."""
    b, n, co, *out_sp = dy.shape
    ci, ks = w.shape[2], w.shape[3:]
    dxp = dy.new_zeros([b * n, ci] + [x_shape[3 + i] + sum(pads[i]) for i in range(len(ks))],
                       dtype=torch.float32)
    dyf = dy.float().reshape(b, n, co, -1)
    wf = w.float()
    for t in _taps(ks):
        dxp[_tap_slice(t, out_sp, stride)] += torch.matmul(
            wf[(slice(None),) * 3 + t].transpose(1, 2).unsqueeze(1), dyf).reshape(
                [b * n, ci] + out_sp)
    crop = (slice(None), slice(None)) + tuple(
        slice(pads[i][0], pads[i][0] + x_shape[3 + i]) for i in range(len(ks)))
    return dxp[crop].reshape(x_shape)


def _tap_conv_weight_lanes(x, dy, w_shape, stride: int, pads: Pads) -> torch.Tensor:
    """:func:`_tap_conv_weight` of B lanes, float32: (B, O, I, *k)."""
    b, n, co = dy.shape[:3]
    ci = x.shape[2]
    xp, out_sp, taps = _tap_lanes(x, w_shape[3:], stride, pads)
    dyf = dy.float().reshape(b, n, co, -1)
    cols = []
    for t in taps:
        xs = xp[_lane_slice(t, out_sp, stride)].float().reshape(b, n, ci, -1)
        cols.append(torch.matmul(dyf, xs.transpose(2, 3)).sum(1))
    return torch.stack(cols, -1).reshape(w_shape)


def _grouped(x: torch.Tensor) -> torch.Tensor:
    """(B, N, C, *sp) -> (N, B*C, *sp): the lanes as channel groups."""
    b, n, c = x.shape[:3]
    return x.transpose(0, 1).reshape((n, b * c) + tuple(x.shape[3:]))


def _ungrouped(y: torch.Tensor, b: int) -> torch.Tensor:
    """(N, B*O, *sp) -> (B, N, O, *sp)."""
    n = y.shape[0]
    return y.reshape((n, b, -1) + tuple(y.shape[2:])).transpose(0, 1)


class _ConvSameLanes(torch.autograd.Function):
    """B lanes of :class:`_ConvSame`: x (B, N, C, *sp), w (B, O, I, *k)."""

    @staticmethod
    def forward(ctx, x, w, stride, pads, mode):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.pads, ctx.mode = stride, pads, mode
        b = x.shape[0]
        if mode == "tapmm":
            return _tap_conv_lanes(x, w, stride, pads)
        conv = _FWD[w.ndim - 3]
        xg, wg = _grouped(x), w.reshape((-1,) + tuple(w.shape[2:]))
        if _symmetric(pads):
            y = conv(xg, wg, stride=stride, padding=tuple(lo for lo, _ in pads), groups=b)
        else:
            y = conv(F.pad(xg, _flat(pads)), wg, stride=stride, groups=b)
        return _ungrouped(y, b)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        nd = w.ndim - 3
        b = x.shape[0]
        stride, pads, tap = ctx.stride, ctx.pads, ctx.mode == "tapmm"
        sym = _symmetric(pads)
        padding = tuple(lo for lo, _ in pads)
        lane_x, lane_w = tuple(x.shape[1:]), tuple(w.shape[1:])
        xg, wg, dyg = _grouped(x), w.reshape((-1,) + tuple(w.shape[2:])), _grouped(dy)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            if tap:
                dx = _tap_conv_input_lanes(dy, w, x.shape, stride, pads).to(x.dtype)
            elif sym:
                dx = _ungrouped(_DX[nd](xg.shape, wg, dyg, stride=stride, padding=padding,
                                        groups=b), b)
            else:
                xp_shape = xg.shape[:2] + tuple(xg.shape[2 + i] + lo + hi
                                                for i, (lo, hi) in enumerate(pads))
                dxp = _DX[nd](xp_shape, wg, dyg, stride=stride, groups=b)
                dx = _ungrouped(dxp[(slice(None), slice(None)) + tuple(
                    slice(lo, lo + xg.shape[2 + i]) for i, (lo, _) in enumerate(pads))], b)
        if ctx.needs_input_grad[1]:
            if use_wgrad_kernel(lane_x, lane_w, stride, pads):
                dw = wgrad3d_lanes(x[:, 0], dy[:, 0], w.shape[3]).to(w.dtype)
            elif _use_packed(lane_x, lane_w, stride, pads, x.element_size()):
                wg_fn = _packed_wgrad if stride == 1 else _folded_wgrad
                dw = torch.stack([wg_fn(x[i], dy[i], lane_w, stride, pads)
                                  for i in range(b)]).to(w.dtype)
            elif tap:
                dw = _tap_conv_weight_lanes(x, dy, tuple(w.shape), stride, pads).to(w.dtype)
            else:
                xin = xg if sym else F.pad(xg, _flat(pads))
                dw = _DW[nd](xin, wg.shape, dyg, stride=stride,
                             padding=padding if sym else 0, groups=b).reshape(w.shape)
        return dx, dw, None, None, None


def conv_same(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
              padding: Padding = 0) -> torch.Tensor:
    """Zero-padded conv (N, C, *spatial) x (O, I, *window), one stride for
    every spatial dim; ``padding`` one int for every side, or a (lo, hi)
    pair a spatial dim. Runs as the calling thread's ``conv_impl``."""
    return _ConvSame.apply(x, w, stride, _pairs(padding, w.ndim - 2), current_conv_impl())
