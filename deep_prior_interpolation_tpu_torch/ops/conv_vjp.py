"""Same-pad convolution whose weight gradient can run on the wgrad kernel.

Counterpart of ``ops/conv_vjp.py``'s ``conv_same``. The forward conv and
the data gradient stay on cuDNN (``F.conv2d``/``F.conv3d`` and
``torch.nn.grad.conv*_input``), as the JAX package leaves them to XLA. The
weight gradient comes from the hand-written kernel of ``ops/wgrad.py`` when
``DPI_PALLAS_WGRAD=1`` (the JAX package's own switch, read at call time) and
``wgrad_supported`` admits the conv; otherwise from
``torch.nn.grad.conv*_weight``. dW is returned in the weight's dtype, so a
bf16 net rounds the kernel's float32 sum to bf16, as the JAX package does.

The JAX package's alternative formulations (``tapmm``, packed and folded
weight gradients) are not ported yet (ROADMAP A.12).
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from .wgrad import wgrad3d, wgrad_supported

__all__ = ["conv_same", "use_wgrad_kernel"]

_FWD = {2: F.conv2d, 3: F.conv3d}
_DX = {2: torch.nn.grad.conv2d_input, 3: torch.nn.grad.conv3d_input}
_DW = {2: torch.nn.grad.conv2d_weight, 3: torch.nn.grad.conv3d_weight}


def use_wgrad_kernel(x_shape, w_shape, stride: int, padding: int) -> bool:
    """Does the weight gradient of this conv go to the wgrad kernel?"""
    if os.environ.get("DPI_PALLAS_WGRAD", "0") != "1":
        return False
    return wgrad_supported(tuple(x_shape), tuple(w_shape), stride, padding)


class _ConvSame(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        return _FWD[w.ndim - 2](x, w, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        nd = w.ndim - 2
        stride, padding = ctx.stride, ctx.padding
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _DX[nd](x.shape, w, dy, stride=stride, padding=padding)
        if ctx.needs_input_grad[1]:
            if use_wgrad_kernel(x.shape, w.shape, stride, padding):
                dw = wgrad3d(x, dy, w.shape[2]).to(w.dtype)
            else:
                dw = _DW[nd](x, w.shape, dy, stride=stride, padding=padding)
        return dx, dw, None, None


def conv_same(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
              padding: int = 0) -> torch.Tensor:
    """Zero-padded conv (N, C, *spatial) x (O, I, *window), one stride and
    one symmetric padding for every spatial dim."""
    return _ConvSame.apply(x, w, stride, padding)
