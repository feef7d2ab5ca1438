"""The x2 half-pixel linear upsample with a deterministic backward: a CUDA
kernel for sm_90a and its plain version.

``linear_upsample2x`` is the bilinear (2D) or trilinear (3D) resize by 2 with
``align_corners=False`` (the JAX package's ``jax.image.resize(...,
"linear")`` at factor 2). Its forward is ``F.interpolate``, a gather.
PyTorch's CUDA backward of it scatters with atomic adds, whose order changes
from run to run; here the backward is a gather in a fixed order, so two runs
from one state stay bit-equal, which an exact resume needs. No TPU kernel
stands behind it: the JAX package leaves that backward to XLA.

Along each axis of n input samples, input i gathers its four output
gradients with fixed weights:
``0.25 g[2i-1] + w0 g[2i] + w1 g[2i+1] + 0.25 g[2i+2]``, with w0 = 0.75
(1 at i = 0), w1 = 0.75 (1 at i = n-1) and g outside [0, 2n) read as 0;
the axes in the order W, H, D, in float32, rounded once to the gradient's
dtype. ``csrc/upsample.cu`` holds the kernel, its design and what bounds it
on an H100 (bytes); ``ops/_build.py`` compiles it at first use.

``upsample_bwd`` takes the plain version for tensors on the CPU and launches
the kernel for CUDA tensors (any other device raises); ``upsample_bwd.launches``
counts the launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["linear_upsample2x", "upsample_bwd", "upsample_bwd_plain"]

_MODES = {2: "bilinear", 3: "trilinear"}
_SMS = 132   # H100 SXM
_THREADS = 256


def _axis_bwd(g: torch.Tensor, axis: int) -> torch.Tensor:
    """The gather along ``axis`` (2n samples -> n), each product and sum
    rounded in the kernel's order."""
    gm = g.movedim(axis, -1)
    n = gm.shape[-1] // 2
    even, odd = gm[..., 0::2], gm[..., 1::2]
    before = F.pad(odd[..., :-1], (1, 0))   # g[2i - 1]
    after = F.pad(even[..., 1:], (0, 1))    # g[2i + 2]
    w0 = torch.full((n,), 0.75, dtype=g.dtype, device=g.device)
    w1 = w0.clone()
    w0[0] = 1.0
    w1[-1] = 1.0
    s = before * 0.25
    s = s + even * w0
    s = s + odd * w1
    s = s + after * 0.25
    return s.movedim(-1, axis)


def upsample_bwd_plain(grad_out: torch.Tensor, ndim: int) -> torch.Tensor:
    """d/dx of ``<grad_out, linear_upsample2x(x)>`` as plain tensor code: the
    gather along the last ``ndim`` dims (W, then H, then D) in float32 (float64
    for a float64 gradient), then rounded to grad_out's dtype."""
    g = grad_out.to(torch.promote_types(grad_out.dtype, torch.float32))
    for axis in range(g.ndim - 1, g.ndim - 1 - ndim, -1):
        g = _axis_bwd(g, axis)
    return g.to(grad_out.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("upsample")
    # without argtypes ctypes would pass each pointer as a 32-bit int
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dpi_upsample_bwd.argtypes = [p, p, ll, i, i, i, i, i, i, i, i, p]
    lib.dpi_upsample_bwd.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def launch_grid(planes: int, d: int, h: int, w: int) -> Tuple[int, int, int]:
    """(th, tw, span): a block of tw x th threads over a tile of the input
    (tw 8, 16 or 32 columns, at most 256 threads) and ``span`` D planes a
    block walks, as many as leave about 16 blocks an SM."""
    tw = 32 if w > 16 else 16 if w > 8 else 8
    th = min(_THREADS // tw, 1 << max(0, (h - 1).bit_length()))
    tiles = planes * -(-h // th) * -(-w // tw)
    ranges = max(1, min(d, -(-16 * _SMS // tiles)))
    return th, tw, -(-d // ranges)


def _validate(grad_out: torch.Tensor, ndim: int) -> None:
    if ndim not in _MODES or grad_out.dim() != ndim + 2:
        raise ValueError(f"upsample_bwd takes an (N, C, *spatial) gradient of 2 or 3 "
                         f"spatial dims, got {tuple(grad_out.shape)} with ndim={ndim}")
    if any(s % 2 for s in grad_out.shape[2:]):
        raise ValueError(f"the gradient of a x2 upsample has even spatial sizes, got "
                         f"{tuple(grad_out.shape)}")


def upsample_bwd(grad_out: torch.Tensor, ndim: int) -> torch.Tensor:
    """The gradient (N, C, *spatial / 2) of the x2 linear upsample, in
    grad_out's dtype. Plain version on the CPU; one launch of the CUDA kernel
    on CUDA tensors (bfloat16 or float32; any other device raises)."""
    _validate(grad_out, ndim)
    if grad_out.device.type == "cpu":
        return upsample_bwd_plain(grad_out, ndim)
    if not grad_out.is_cuda:
        raise ValueError(f"upsample_bwd runs on the CPU or a CUDA device, got {grad_out.device}")
    if grad_out.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"upsample_bwd takes bfloat16 or float32, got {grad_out.dtype}")
    g = grad_out.contiguous()
    n, c, *sp = g.shape
    sp = [s // 2 for s in sp]
    d, h, w = ([1] + sp) if ndim == 2 else sp
    gin = torch.empty((n, c, *sp), dtype=g.dtype, device=g.device)
    if gin.numel():
        th, tw, span = launch_grid(n * c, d, h, w)
        dev = g.device.index
        rc = _library().dpi_upsample_bwd(
            g.data_ptr(), gin.data_ptr(), n * c, d, h, w, int(ndim == 3),
            int(g.dtype == torch.bfloat16), th, tw, span, torch._C._cuda_getCurrentRawStream(dev))
        if rc != 0:
            raise RuntimeError(f"upsample_bwd kernel launch failed: CUDA error {rc} "
                               f"(grad_out {tuple(g.shape)})")
        upsample_bwd.launches += 1
    return gin


upsample_bwd.launches = 0


class _LinearUpsample2x(torch.autograd.Function):
    """``F.interpolate`` forward; the gather backward of ``upsample_bwd``.
    Under ``torch.func.vmap`` the lanes fold into the batch dim, (B*N, C,
    *spatial): the upsample is per plane, so the one kernel launch of the
    backward covers all lanes' planes."""

    @staticmethod
    def forward(x):
        return F.interpolate(x, scale_factor=2, mode=_MODES[x.dim() - 2], align_corners=False)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.ndim = inputs[0].dim() - 2

    @staticmethod
    def backward(ctx, g):
        return upsample_bwd(g, ctx.ndim)

    @staticmethod
    def vmap(info, in_dims, x):
        x = x.movedim(in_dims[0], 0)
        y = _LinearUpsample2x.apply(x.reshape((-1,) + tuple(x.shape[2:])))
        return y.reshape(tuple(x.shape[:2]) + tuple(y.shape[1:])), 0


def linear_upsample2x(x: torch.Tensor) -> torch.Tensor:
    """The x2 half-pixel linear resize of an (N, C, H, W) or (N, C, D, H, W)
    tensor, with a deterministic backward."""
    if x.dim() - 2 not in _MODES:
        raise ValueError(f"linear_upsample2x takes 2 or 3 spatial dims, got {tuple(x.shape)}")
    return _LinearUpsample2x.apply(x)
