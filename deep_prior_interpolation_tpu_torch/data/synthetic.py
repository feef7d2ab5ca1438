"""Synthetic seismic volumes and masks (counterpart of ``data/synthetic.py``).

Hyperbolic diffraction events over a (t, x[, y]) grid, the random
trace-decimation mask of the flagship benchmark (66 % of the traces removed,
the same traces at every time sample), and a (volume, mask) pair decimated
by ``ops.masks.build_mask``. ``synth_hyperbolic`` is the JAX repository's
benchmark volume (``bench.py``), the data of its 3D quality runs.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def hyperbolic_events(nt: int = 256, nx: int = 128, ny: Optional[int] = 128,
                      n_events: int = 6, sigma_t: float = 2.0,
                      seed: int = 0) -> np.ndarray:
    """(t, x[, y]) volume with hyperbolic moveout events, peak-normalised."""
    rng = np.random.RandomState(seed)
    is3d = ny is not None
    t = np.arange(nt, dtype=np.float32)
    x = (np.arange(nx, dtype=np.float32) - nx / 2)
    if is3d:
        t = t[:, None, None]
        xg = x[None, :, None]
        yg = (np.arange(ny, dtype=np.float32) - ny / 2)[None, None, :]
        r2 = xg ** 2 + yg ** 2
        vol = np.zeros((nt, nx, ny), np.float32)
    else:
        t = t[:, None]
        r2 = (x ** 2)[None, :]
        vol = np.zeros((nt, nx), np.float32)

    for _ in range(n_events):
        t0 = rng.uniform(0.1 * nt, 0.85 * nt)
        v = rng.uniform(2.0, 6.0)
        amp = rng.uniform(0.5, 1.0) * rng.choice([-1, 1])
        tt = np.sqrt(t0 ** 2 + r2 / (v * v))
        vol += amp * np.exp(-0.5 * ((t - tt) / sigma_t) ** 2)
    peak = np.abs(vol).max()
    return vol / peak if peak > 0 else vol


def synth_hyperbolic(nt: int = 256, nx: int = 128, ny: int = 128,
                     seed: int = 0) -> np.ndarray:
    """The JAX repository's benchmark volume (its ``bench.synth_hyperbolic``,
    the poc_3D and quality_3d data): six hyperbolic events with float64
    moveout, peak-normalised, float32. Not ``hyperbolic_events``: the event
    times are drawn from another range."""
    rng = np.random.RandomState(seed)
    t = np.arange(nt)[:, None, None]
    x = (np.arange(nx) - nx / 2)[None, :, None]
    y = (np.arange(ny) - ny / 2)[None, None, :]
    vol = np.zeros((nt, nx, ny), np.float32)
    for _ in range(6):
        t0 = rng.uniform(20, nt - 40)
        v = rng.uniform(2.0, 6.0)
        amp = rng.uniform(0.5, 1.0) * rng.choice([-1, 1])
        tt = np.sqrt(t0 ** 2 + (x / v) ** 2 + (y / v) ** 2)
        vol += amp * np.exp(-0.5 * ((t - tt) / 2.0) ** 2)
    vol /= np.abs(vol).max()
    return vol


def source_wavelet(points: int = 51, a: float = 4.0) -> np.ndarray:
    """Ricker wavelet, float32, for the wavelet shaping of the input canvas."""
    from ..ops.filters import ricker_wavelet
    return ricker_wavelet(points, a).numpy()


def decimated_pair(nt: int = 256, nx: int = 128, ny: Optional[int] = 128,
                   rate: float = 0.66, regular: bool = False, seed: int = 0):
    """(volume, mask) with ``rate`` of the traces removed (``build_mask``,
    its generator seeded from ``seed + 1``)."""
    from ..ops.masks import build_mask
    vol = hyperbolic_events(nt, nx, ny, seed=seed)
    mask = build_mask(vol, rate, regular=regular,
                      rng=np.random.default_rng(seed + 1)).astype(np.float32)
    return vol, mask


def random_trace_mask(shape, rate: float = 0.66, seed: int = 1) -> np.ndarray:
    """float32 mask of ``shape`` (t, x[, y]) keeping each trace with
    probability 1 - ``rate``; a kept trace is kept at every time sample."""
    rng = np.random.RandomState(seed)
    traces = (rng.rand(1, *shape[1:]) > rate).astype(np.float32)
    return np.repeat(traces, shape[0], 0)


def flagship_problem(nt: int = 256, nx: int = 128, ny: int = 128,
                     gain: float = 40.0, seed: int = 0):
    """(img, mask), each (nt, nx, ny, 1) float32: the hyperbolic volume
    times ``gain`` and its 66 % random trace decimation."""
    vol = hyperbolic_events(nt, nx, ny, seed=seed)
    mask = random_trace_mask(vol.shape, 0.66, seed + 1)
    return (vol * gain)[..., None].astype(np.float32), mask[..., None]
