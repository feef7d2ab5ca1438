"""Adjoint-pair linear operators (counterpart of ``ops/linops.py``).

Operators are ``(forward, adjoint)`` pairs of functions of tensors wrapped
in a small :class:`LinearOperator`: composition (``chain``), the normal
operator (``hessian``), the dot-product adjoint test (``dottest``, which
returns its errors), the vertical forward difference, the vertical
convolution with a wavelet and the linearised AVO modelling, each with its
hand-written adjoint. :func:`auto_adjoint` derives the adjoint of any
linear forward as its vector-Jacobian product (``torch.func.vjp``), where
the JAX package uses ``jax.linear_transpose``.

Tensors are the port's own layout, (N, C, *spatial): the vertical (first
spatial) axis is dim 2, and the AVO operator's model and data channels are
dim 1.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .filters import convolve_kernel_1d

__all__ = ["LinearOperator", "auto_adjoint", "avo_modelling", "chain", "dottest",
           "hessian", "vertical_conv", "vertical_grad"]


@dataclass(frozen=True)
class LinearOperator:
    """A forward/adjoint pair, callable as the forward map."""
    forward: Callable[[torch.Tensor], torch.Tensor]
    adjoint: Callable[[torch.Tensor], torch.Tensor]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward(x)

    def H(self, y: torch.Tensor) -> torch.Tensor:
        return self.adjoint(y)


def auto_adjoint(forward: Callable, example_input: torch.Tensor) -> LinearOperator:
    """The adjoint of a linear ``forward`` as its vector-Jacobian product,
    taken at zero (for a linear map it is the same everywhere)."""
    def adj(y):
        _, vjp = torch.func.vjp(forward, torch.zeros_like(example_input))
        return vjp(y)[0]

    return LinearOperator(forward, adj)


def chain(ops: Sequence[LinearOperator]) -> LinearOperator:
    """Composition, applied left to right; the adjoint right to left."""
    assert len(ops) >= 1

    def fwd(x):
        for op in ops:
            x = op.forward(x)
        return x

    def adj(y):
        for op in reversed(ops):
            y = op.adjoint(y)
        return y

    return LinearOperator(fwd, adj)


def hessian(op: LinearOperator) -> LinearOperator:
    """The normal operator F^T F, self-adjoint."""
    def fwd(x):
        return op.adjoint(op.forward(x))
    return LinearOperator(fwd, fwd)


def dottest(op: LinearOperator, domain_shape, range_shape,
            generator: Optional[torch.Generator] = None,
            dtype: torch.dtype = torch.float32) -> Tuple[float, float]:
    """``<F d, r> == <d, F^T r>`` on random d and r; returns (abs_err,
    rel_err)."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    d1 = torch.randn(tuple(domain_shape), generator=gen, dtype=dtype)
    r1 = torch.randn(tuple(range_shape), generator=gen, dtype=dtype)
    lhs = torch.vdot(d1.reshape(-1), op.adjoint(r1).reshape(-1))
    rhs = torch.vdot(r1.reshape(-1), op.forward(d1).reshape(-1))
    return float((lhs - rhs).abs()), float(((lhs - rhs) / lhs).abs())


# ----------------------------------------------------------------------
# concrete operators
# ----------------------------------------------------------------------

def vertical_grad() -> LinearOperator:
    """Forward difference along the vertical axis (dim 2), 0 in the last
    row, with its true adjoint."""
    def fwd(x):
        return F.pad(x[:, :, 1:] - x[:, :, :-1], _pad_dim2(x, 0, 1))

    def adj(y):
        d = y[:, :, :-1]
        return F.pad(d, _pad_dim2(y, 1, 0)) - F.pad(d, _pad_dim2(y, 0, 1))

    return LinearOperator(fwd, adj)


def _pad_dim2(x: torch.Tensor, before: int, after: int) -> Tuple[int, ...]:
    """``F.pad`` widths that pad dim 2 of ``x`` only."""
    return (0, 0) * (x.ndim - 3) + (before, after)


def vertical_conv(wavelet: np.ndarray) -> LinearOperator:
    """Each trace convolved with ``wavelet / 2`` along the vertical axis
    (dim 2), channel by channel; the adjoint is the correlation."""
    w = torch.as_tensor(np.asarray(wavelet, np.float32) / 2.0)

    def fwd(x):
        # convolve_kernel_1d correlates with flip(taps): a convolution with taps
        return convolve_kernel_1d(x, w, axis=2)

    def adj(y):
        return convolve_kernel_1d(y, w.flip(0), axis=2)

    return LinearOperator(fwd, adj)


def _avo_coeffs(theta, vsvp, n: int, linearization: str) -> torch.Tensor:
    """The Aki-Richards or Fatti 3-term coefficients, (ntheta, 3, nt0)."""
    theta = torch.deg2rad(torch.as_tensor(np.asarray(theta, np.float32)))
    vsvp = torch.as_tensor(np.asarray(vsvp, np.float32))
    if vsvp.ndim == 0:
        vsvp = vsvp * torch.ones(n)
    theta = theta[:, None]
    vsvp = vsvp[None, :]
    if linearization == "fatti":
        t2 = torch.tan(theta) ** 2
        s2 = torch.sin(theta) ** 2
        g1 = 0.5 * (1.0 + t2) + 0 * vsvp
        g2 = -4.0 * vsvp ** 2 * s2
        g3 = 0.5 * (4 * vsvp ** 2 * s2 - t2)
    else:  # akirich
        c2 = torch.cos(theta) ** 2
        s2 = torch.sin(theta) ** 2
        g1 = 1.0 / (2.0 * c2) + 0 * vsvp
        g2 = -4.0 * vsvp ** 2 * s2
        g3 = 0.5 - 2.0 * vsvp ** 2 * s2
    return torch.stack([g1, g2, g3], dim=1)


def avo_modelling(theta, vsvp: Union[float, np.ndarray] = 0.5, nt0: int = 1,
                  spatdims: Union[int, Tuple[int, ...], None] = None,
                  linearization: str = "akirich") -> LinearOperator:
    """Linearised AVO modelling: 3 model channels -> one data channel per
    angle of ``theta`` (degrees). x is (1, 3, nt0, *spatdims), the data
    (1, ntheta, nt0, *spatdims)."""
    n = int(np.asarray(vsvp).size) if np.ndim(vsvp) > 0 else nt0
    nsp = 0 if spatdims is None else (len(spatdims) if isinstance(spatdims, tuple) else 1)
    g = _avo_coeffs(theta, vsvp, n, linearization)
    g = g.reshape(g.shape + (1,) * nsp)[None]   # (1, ntheta, 3, nt0, *1s)

    def fwd(x):
        return (x[:, None] * g.to(x.device, x.dtype)).sum(2)

    def adj(y):
        return (y[:, :, None] * g.to(y.device, y.dtype)).sum(1)

    return LinearOperator(fwd, adj)
