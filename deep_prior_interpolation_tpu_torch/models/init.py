"""Weight initialisation registry (counterpart of ``models/init.py``).

normal / xavier / kaiming / orthogonal conv-kernel init, zero biases, and
the reference's Norm-scale init N(10, 10*gain). Kernels are stored OIDHW
(OIHW in 2D; a transposed conv's (in, out, *window)), but the fans, and the
matrix that ``orthogonal`` makes orthogonal, are those of the JAX package's
DHWIO kernel, so both packages draw from the same distribution. Dense
kernels (rank 2) keep flax's lecun-normal init under every scheme, as in the
JAX package. Draws come from an explicit ``torch.Generator``; the streams
differ from JAX's keys.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .blocks import ConvTranspose


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


def _truncated(shape, scale: float, gen: torch.Generator) -> torch.Tensor:
    """flax's variance-scaling 'truncated_normal' (fan_in mode): a normal
    truncated at +-2 std, with variance scale / fan_in once truncated."""
    std = math.sqrt(scale / _fans(shape)[0]) / 0.87962566103423978
    return nn.init.trunc_normal_(torch.empty(shape), 0.0, std, -2 * std, 2 * std,
                                 generator=gen)


def _default_kernel(shape, init: str, gen: torch.Generator) -> torch.Tensor:
    """The kernel a flax module draws by itself: lecun_normal (``Conv``,
    ``nn.ConvTranspose``, ``Dense``), kaiming_normal (``nn.Conv`` of the
    partial conv) or orthogonal (the ConvGRU's gates)."""
    if init == "orthogonal":
        return _orthogonal(shape, 1.0, gen)
    return _truncated(shape, 2.0 if init == "kaiming" else 1.0, gen)


def _init_kernel(shape, inittype: str, gain: float, gen: torch.Generator) -> torch.Tensor:
    fan_in, fan_out = _fans(shape)
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
    * Dense kernels (rank 2) -> flax's lecun normal
    * biases -> 0
    * Norm 'scale' -> N(10, 10*gain)   [reference quirk]

    ``inittype='default'`` draws flax's own initialisers instead, as the
    JAX package keeps them: each kernel its module's (``kernel_init``,
    lecun normal unless the module says otherwise), Norm scale 1, biases 0.
    """
    for _, m in model.named_modules():
        for leaf, p in m.named_parameters(recurse=False):
            if leaf == "kernel" and p.ndim >= 3:
                io = isinstance(m, ConvTranspose)  # (in, out, *window)
                oi = (p.shape[1], p.shape[0]) + tuple(p.shape[2:]) if io else tuple(p.shape)
                k = (_default_kernel(oi, getattr(m, "kernel_init", "lecun"), gen)
                     if inittype == "default" else _init_kernel(oi, inittype, gain, gen))
                p.copy_(k.transpose(0, 1) if io else k)
            elif leaf == "kernel":
                p.copy_(_truncated(tuple(p.shape), 1.0, gen))
            elif leaf == "scale":
                p.copy_(torch.ones_like(p) if inittype == "default"
                        else 10.0 + 10.0 * gain * torch.randn(p.shape, generator=gen))
            elif leaf == "bias":
                p.zero_()
    return model
