"""Local-dip estimation and slope regularisation (counterpart of
``ops/slopes.py``).

The structure-tensor local dip and anisotropy (van Vliet & Verbeek 1995),
the directional Laplacian steered by a dip field, and its form with the
rotation computed once, ``Hale2D``. Tensors are (N, C, H, W): the vertical
axis is dim 2, the horizontal dim 3.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .filters import first_derivative, gaussian_filter

__all__ = ["Hale2D", "directional_laplacian", "structure_tensor_dips"]


def structure_tensor_dips(x: torch.Tensor, dv: float = 1.0, dh: float = 1.0,
                          smooth: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Local dip angle and anisotropy of an (N, C, H, W) tensor."""
    gv = first_derivative(x, spacing=dv, axis=2, stencil="forward")
    gh = first_derivative(x, spacing=dh, axis=3, stencil="forward")
    gvv, gvh, ghh = gv * gv, gv * gh, gh * gh

    if smooth > 0:
        ks = 2 * min(x.shape[2], x.shape[3]) // 2 + 1
        gvv = gaussian_filter(gvv, ks, smooth)
        gvh = gaussian_filter(gvh, ks, smooth)
        ghh = gaussian_filter(ghh, ks, smooth)

    term1 = 0.5 * (gvv + ghh)
    term2 = 0.5 * torch.sqrt((gvv - ghh) ** 2 + 4 * gvh ** 2)
    eig1 = term1 + term2
    eig2 = term1 - term2

    phi1 = torch.nan_to_num(torch.atan((eig1 - gvv) / gvh), nan=0.0)
    anisotropy = 1 - eig2 / eig1
    return phi1, anisotropy


def _steered(x: torch.Tensor, a, b, c) -> torch.Tensor:
    """-(d/dh (a gv + b gh) + d/dv (b gv + c gh)) with forward differences."""
    grad_v = first_derivative(x, axis=2, stencil="forward")
    grad_h = first_derivative(x, axis=3, stencil="forward")
    r1 = a * grad_v + b * grad_h
    r2 = b * grad_v + c * grad_h
    return -(first_derivative(r1, axis=3, stencil="forward")
             + first_derivative(r2, axis=2, stencil="forward"))


def directional_laplacian(x: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Anisotropic Laplacian steered by the dip field ``theta``."""
    u1 = torch.cos(theta)
    u2 = -torch.sin(theta)
    return _steered(x, u1 * u1, u1 * u2, u2 * u2)


class Hale2D:
    """The directional Laplacian with its rotation computed once."""

    def __init__(self, directions: torch.Tensor):
        u1 = torch.cos(directions)
        u2 = -torch.sin(directions)
        self.a = u1 * u1
        self.b = u1 * u2
        self.c = u2 * u2
        self.dips = directions

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _steered(x, self.a, self.b, self.c)
