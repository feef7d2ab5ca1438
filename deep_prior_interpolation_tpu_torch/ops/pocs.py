"""POCS (projection onto convex sets) spectral projection (counterpart of
``ops/pocs.py``), on ``torch.fft``.

The threshold is a hard one per component: the real and the imaginary part
of each coefficient are kept or zeroed on their own, against a threshold
taken from the maximum over both components. It is not a magnitude
threshold.

Tensors are channels-first, ``(N, C, *spatial)``, so the spatial axes that
``fk_projection`` and ``POCS`` transform by default are ``2 .. ndim-1``.
``torch.fft`` takes no bfloat16: a bfloat16 input is transformed in float32
(exact) and its projection rounded back to bfloat16.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def _fft_input(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype in (torch.float32, torch.float64) else x.float()


def _component_threshold(x: torch.Tensor, thresh) -> torch.Tensor:
    """Keep the entries with |x| > thresh, zero the others."""
    keep = (x > thresh).to(x.dtype) + (x < -thresh).to(x.dtype)
    return x * keep


def threshold(spec: torch.Tensor, thresh=None) -> torch.Tensor:
    """Hard-threshold a real or complex tensor (complex: per component)."""
    if thresh is None:
        thresh = compute_threshold(spec)
    if spec.is_complex():
        return torch.complex(_component_threshold(spec.real, thresh),
                             _component_threshold(spec.imag, thresh))
    return _component_threshold(spec, thresh)


def compute_threshold(spec: torch.Tensor, perc: float = 10.0):
    """max(spec) * perc / 100 over all real components."""
    if spec.is_complex():
        m = torch.maximum(spec.real.max(), spec.imag.max())
    else:
        m = spec.max()
    return m * perc / 100.0


def fk_projection(x: torch.Tensor, weighted_data: torch.Tensor,
                  weighted_mask: torch.Tensor, thresh_perc,
                  axes: Optional[Sequence[int]] = None,
                  return_threshold: bool = False):
    """One POCS iteration: FFT -> threshold -> inverse FFT -> data
    re-insertion.

    ``weighted_data = alpha * data`` and ``weighted_mask = 1 - alpha * mask``
    come from the caller. ``axes`` defaults to the spatial axes of a
    channels-first tensor (all but the first two).
    """
    if axes is None:
        axes = tuple(range(2, x.ndim))
    spec = torch.fft.fftn(_fft_input(x), dim=tuple(axes))
    th = compute_threshold(spec, thresh_perc)
    spec = threshold(spec, th)
    proj = torch.fft.ifftn(spec, dim=tuple(axes)).real.to(x.dtype)
    out = weighted_data + weighted_mask * proj
    if return_threshold:
        return out, th
    return out


def pocs_fk_fn(out: torch.Tensor, data: torch.Tensor, mask: torch.Tensor,
               th: float, alp: float = 0.2,
               axes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """One-shot functional POCS step over ``axes`` (all axes by default)."""
    if axes is None:
        axes = tuple(range(out.ndim))
    spec = torch.fft.fftn(_fft_input(out), dim=tuple(axes))
    spec = threshold(spec, th)
    proj = torch.fft.ifftn(spec, dim=tuple(axes)).real.to(out.dtype)
    return alp * data + proj * (1 - alp * mask)


class POCS:
    """Stateful POCS projector.

    ``forward_fn``/``adjoint_fn`` default to the FFT pair over the spatial
    axes of a channels-first tensor.
    """

    def __init__(self, data: torch.Tensor, mask: torch.Tensor, weight: float,
                 forward_fn=None, adjoint_fn=None,
                 thresh_perc: Optional[float] = None):
        self.weighted_data = weight * data
        self.weighted_mask = torch.ones_like(mask) - weight * mask
        self.weight = weight
        axes = tuple(range(2, data.ndim))
        self.forward_fn = forward_fn or (
            lambda x: torch.fft.fftn(_fft_input(x), dim=axes))
        self.adjoint_fn = adjoint_fn or (
            lambda s: torch.fft.ifftn(s, dim=axes).real.to(data.dtype))
        self.thresh_perc = thresh_perc

    def __call__(self, x: torch.Tensor, thresh=None) -> torch.Tensor:
        spec = self.forward_fn(x)
        th = (compute_threshold(spec, self.thresh_perc)
              if self.thresh_perc is not None else thresh)
        spec = threshold(spec, th)
        proj = self.adjoint_fn(spec)
        return self.weighted_data + self.weighted_mask * proj

    def __repr__(self) -> str:
        return f"POCS(weight={self.weight:.3f})"
