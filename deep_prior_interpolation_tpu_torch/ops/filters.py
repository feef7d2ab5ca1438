"""Signal-processing ops (counterpart of ``ops/filters.py``).

NaN-coded traces to a binary mask, the sqrt(t) gain, 1-D filtering along
one axis (the input canvas's wavelet and Butterworth shaping), the
Butterworth-to-FIR low-pass design, Gaussian and Ricker kernels, a
separable Gaussian blur and finite differences.

Tensors are the port's own layout, (N, C, *spatial): ``axis`` is a dim of
the tensor, so the first spatial axis is 2. Filter *design* (scipy) stays on
the host at setup time, as in the JAX package; only the application runs on
the tensor's device.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def bool2bin(x: np.ndarray, logic: bool = True) -> np.ndarray:
    """NaN-coded corrupted traces -> binary mask (0 at NaN when ``logic``)."""
    out = np.where(np.isnan(x), 0.0 if logic else 1.0, 1.0 if logic else 0.0)
    return out.astype(np.float32 if x.dtype.kind == "f" else x.dtype)


def _tgain(shape, time_step: float, velo: float) -> np.ndarray:
    nt = shape[0]
    step = time_step * velo
    t = np.linspace(step, nt * step, nt)
    return np.sqrt(t).reshape((nt,) + (1,) * (len(shape) - 1))


def normalize(image: np.ndarray, time_step: float, velo: float) -> np.ndarray:
    """sqrt(t) gain along the leading time axis."""
    return image * _tgain(image.shape, time_step, velo)


def denormalize(image: np.ndarray, time_step: float, velo: float) -> np.ndarray:
    return image / _tgain(image.shape, time_step, velo)


def convolve_kernel_1d(x: torch.Tensor, taps, axis: int) -> torch.Tensor:
    """Filter ``x`` along dim ``axis`` with 1-D ``taps``, same-size output:
    a correlation with the flipped taps over zero padding of ``w // 2``
    before and ``w - 1 - w // 2`` after, in ``x``'s dtype."""
    taps = torch.as_tensor(taps, dtype=torch.float32).flip(0).to(x.device, x.dtype)
    width = taps.shape[0]
    pad = width // 2
    xm = x.movedim(axis, -1)
    lead, length = xm.shape[:-1], xm.shape[-1]
    xr = F.pad(xm.reshape(-1, 1, length), (pad, width - 1 - pad))
    y = F.conv1d(xr, taps.view(1, 1, width))
    return y.reshape(lead + (length,)).movedim(-1, axis)


def lowpass_butterworth_taps(fc: float, fs: Optional[float] = None,
                             ntaps: int = 101, order: int = 2,
                             nfft: int = 1024) -> np.ndarray:
    """FIR taps matching a Butterworth magnitude response (least squares)."""
    from scipy.signal import butter, firls, freqz
    b, a = butter(order, fc, fs=fs, btype="low", analog=False)
    w_iir, h_iir = freqz(b, a, worN=nfft, fs=fs)
    return firls(ntaps, w_iir, np.abs(h_iir), fs=fs).astype(np.float32)


def gaussian_kernel(m: int, std: float, sym: bool = True) -> torch.Tensor:
    """1-D Gaussian window, float32."""
    assert m > 1
    odd = m % 2
    mm = m if (sym or odd) else m + 1
    n = torch.arange(0, mm, dtype=torch.float32) - (mm - 1.0) / 2.0
    w = torch.exp(-(n ** 2) / (2 * std * std))
    return w if (sym or odd) else w[:-1]


def ricker_wavelet(points: int, a: float) -> torch.Tensor:
    """Ricker (mexican-hat) wavelet, float32."""
    amp = 2 / (math.sqrt(3 * a) * (math.pi ** 0.25))
    vec = torch.arange(0, points, dtype=torch.float32) - (points - 1.0) / 2
    xsq = vec ** 2
    wsq = a ** 2
    return amp * (1 - xsq / wsq) * torch.exp(-xsq / (2 * wsq))


def gaussian_filter(x: torch.Tensor, kernel_size: int, std: float) -> torch.Tensor:
    """Separable isotropic Gaussian blur over the spatial dims of an
    (N, C, *spatial) tensor."""
    w = gaussian_kernel(kernel_size, std).to(x.dtype)
    for ax in range(2, x.ndim):
        x = convolve_kernel_1d(x, w, axis=ax)
    return x


def first_derivative(x: torch.Tensor, spacing: float = 1.0, axis: int = 0,
                     stencil: str = "forward") -> torch.Tensor:
    x = x.movedim(axis, 0)
    g = torch.zeros_like(x)
    if stencil == "centered":
        g[1:-1] = (0.5 * x[2:] - 0.5 * x[:-2]) / spacing
    elif stencil == "forward":
        g[:-1] = (x[1:] - x[:-1]) / spacing
    elif stencil == "backward":
        g[1:] = (x[1:] - x[:-1]) / spacing
    else:
        raise ValueError("Stencil has to be centered, forward or backward")
    return g.movedim(0, axis)


def second_derivative(x: torch.Tensor, spacing: float = 1.0,
                      axis: int = 0) -> torch.Tensor:
    x = x.movedim(axis, 0)
    g = torch.zeros_like(x)
    g[1:-1] = (x[2:] - 2 * x[1:-1] + x[:-2]) / spacing ** 2
    return g.movedim(0, axis)
