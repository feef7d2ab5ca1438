"""Trace-decimation mask synthesis and progressive mask growth (counterpart
of ``ops/masks.py``), in numpy and scipy.

Every random draw comes from the ``np.random.Generator`` the caller passes,
so the same generator gives the same masks as the JAX package.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
from scipy.ndimage import grey_dilation


def build_mask(data: np.ndarray, rate: float, regular: bool = False,
               rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Binary trace mask over (t, x[, y]) with ``rate`` missing traces.

    Whole traces (every time sample of one x[, y]) are kept or dropped:

    * ``regular``: an every-``p``-th comb, ``p = ceil(n / anchors)``. For
      ``rate >= 0.5`` the anchors (trace 0, p, 2p, ...) survive and the
      traces between them drop; for ``rate < 0.5`` the anchors drop. Traces
      beyond the last full period keep the background value.
    * random: ``rate * n`` distinct traces drawn from ``rng`` are dropped.
    """
    if data.ndim == 2:
        nt = data.shape[0]
        trace_grid = (data.shape[1], 1)
    elif data.ndim == 3:
        nt = data.shape[0]
        trace_grid = data.shape[1:]
    else:
        raise ValueError("data volume has to be either 2D or 3D")

    n = int(np.prod(trace_grid))
    n_drop = int(n * rate)
    col = np.arange(n)

    if regular:
        anchors = (n - n_drop) if rate >= 0.5 else n_drop
        period = -(-n // anchors)  # ceil
        combed = (col < anchors * period) & (col % period != 0)
        keep = ~combed if rate >= 0.5 else combed
    else:
        rng = rng or np.random.default_rng()
        dropped = rng.choice(np.arange(n), n_drop, replace=False)
        keep = np.ones(n, bool)
        keep[dropped] = False

    trace_mask = keep.astype(data.dtype)
    return np.broadcast_to(trace_mask, (nt, n)).reshape(
        (nt,) + trace_grid).squeeze().copy()


def add_rand_mask(mask: np.ndarray, perc: float = 0.3,
                  rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Delete an extra ``perc`` of the surviving traces."""
    m = mask.copy()
    points = np.argwhere(m[0] == 1)
    rng = rng or np.random.default_rng()
    rr = rng.choice(np.arange(points.shape[0]), int(points.shape[0] * perc),
                    replace=False)
    for p in points[rr]:
        m[(slice(None),) + tuple(p)] = 0
    return m


def dilate_mask(mask: np.ndarray, iterations: int = 1) -> np.ndarray:
    """Grow the mask with a 2x2 structuring element, one leading slice at a
    time."""
    shape = mask.shape
    m = np.asarray(mask).squeeze()
    out = np.empty_like(m)
    for i in range(m.shape[0]):
        s = m[i]
        for _ in range(iterations):
            s = grey_dilation(s, footprint=np.ones((2, 2)), mode="constant")
        out[i] = s
    return out.reshape(shape).astype(mask.dtype)


class MaskUpdate:
    """Progressive mask growth schedule: past ``threshold`` iterations the
    mask dilates once every ``step`` iterations, and the traces it gains are
    let in at random, a larger share each iteration of the step."""

    def __init__(self, mask: np.ndarray, threshold: int, step: int,
                 rng: Optional[np.random.Generator] = None) -> None:
        self.threshold = threshold
        self.step = step
        self.iter = 0
        self.new_mask = np.asarray(mask)
        self.old_mask = np.asarray(mask)
        self.rng = rng or np.random.default_rng()

    def update(self, iiter: int) -> np.ndarray:
        mask_return = self.old_mask
        if iiter > self.threshold:
            iiter_dil = (iiter - self.threshold) // self.step + 1
            if iiter_dil > self.iter:
                self.old_mask = self.new_mask
                self.new_mask = dilate_mask(self.old_mask)
                self.iter = iiter_dil
            iter_drop = (iiter - self.threshold) % self.step
            p = 1.0 - 1.0 / self.step * (iter_drop + 1)
            diff = self.new_mask - self.old_mask
            keep = (self.rng.random(diff.shape) >= p) & (diff != 0)
            mask_return = self.old_mask + keep.astype(self.old_mask.dtype)
        return mask_return
