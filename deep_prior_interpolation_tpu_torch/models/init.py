"""Weight initialisation registry (counterpart of ``models/init.py``).

normal / xavier / kaiming / orthogonal conv-kernel init, zero biases, and
the reference's Norm-scale init N(10, 10*gain). Kernels are stored OIDHW
(OIHW in 2D), but the fans, and the matrix that ``orthogonal`` makes
orthogonal, are those of the JAX package's DHWIO kernel, so both packages
draw from the same distribution. Draws come from an explicit
``torch.Generator``; the streams differ from JAX's keys.
"""
from __future__ import annotations

import math

import torch
from torch import nn


def _fans(oi_shape) -> tuple[int, int]:
    """(fan_in, fan_out) of an OI* kernel, as the JAX package computes them
    on the matching *IO kernel: in * receptive, out * receptive."""
    receptive = math.prod(oi_shape[2:]) if len(oi_shape) > 2 else 1
    return oi_shape[1] * receptive, oi_shape[0] * receptive


def _to_oi(k_io: torch.Tensor) -> torch.Tensor:
    """(*window, I, O) -> (O, I, *window)."""
    nd = k_io.ndim - 2
    return k_io.permute(nd + 1, nd, *range(nd)).contiguous()


def _orthogonal(shape, gain: float, gen: torch.Generator) -> torch.Tensor:
    """``jax.nn.initializers.orthogonal(scale=gain, column_axis=-1)`` on the
    *IO view of an OI* kernel: the Co columns of the (prod(window)*Ci, Co)
    matrix are orthonormal (or its rows, when it is wide)."""
    co, ci, *window = shape
    n_rows, n_cols = math.prod(window) * ci, co
    a = torch.randn((max(n_rows, n_cols), min(n_rows, n_cols)), generator=gen)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    if n_rows < n_cols:
        q = q.T
    k_io = (gain * q).reshape(*window, ci, co)
    return _to_oi(k_io)


def _init_kernel(shape, inittype: str, gain: float, gen: torch.Generator) -> torch.Tensor:
    fan_in, fan_out = _fans(shape)
    if inittype == "default":
        # flax's lecun_normal: truncated normal (+-2 std) with variance
        # 1/fan_in, the std corrected for the truncation
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        return nn.init.trunc_normal_(torch.empty(shape), 0.0, std, -2 * std, 2 * std,
                                     generator=gen)
    if inittype == "normal":
        return gain * torch.randn(shape, generator=gen)
    if inittype == "xavier":
        std = gain * math.sqrt(2.0 / (fan_in + fan_out))
        return std * torch.randn(shape, generator=gen)
    if inittype == "kaiming":
        # torch kaiming_normal_(a=0.2, mode='fan_in', leaky_relu)
        std = math.sqrt(2.0 / (1.0 + 0.2 ** 2)) / math.sqrt(fan_in)
        return std * torch.randn(shape, generator=gen)
    if inittype == "orthogonal":
        return _orthogonal(shape, gain, gen)
    raise NotImplementedError(f"initialization method [{inittype}] is not implemented")


@torch.no_grad()
def init_weights(model: nn.Module, gen: torch.Generator, inittype: str = "xavier",
                 gain: float = 0.02) -> nn.Module:
    """Re-draw ``model``'s parameters in place with the chosen scheme.

    * conv kernels (parameters named 'kernel', rank >= 3) -> ``inittype``
    * conv biases -> 0
    * Norm 'scale' -> N(10, 10*gain)   [reference quirk]
    * Norm 'bias' -> 0

    ``inittype='default'`` draws flax's own initialisers instead, as the
    JAX package keeps them: lecun-normal kernels, Norm scale 1, biases 0.
    """
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "kernel" and p.ndim >= 3:
            p.copy_(_init_kernel(tuple(p.shape), inittype, gain, gen))
        elif leaf == "scale" and inittype == "default":
            p.fill_(1.0)
        elif leaf == "scale":
            p.copy_(10.0 + 10.0 * gain * torch.randn(p.shape, generator=gen))
        elif leaf == "bias":
            p.zero_()
    return model
