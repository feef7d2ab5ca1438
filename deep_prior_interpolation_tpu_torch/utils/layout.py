"""Array layout converters (counterpart of ``utils/layout.py``).

numpy helpers between the channels-first layout (the reference code's NCHW /
NCDHW, and the port's tensors) and the channels-last ``(*spatial, C)``
arrays that the solver and the run bundles take, and to add or strip the
batch and channel singleton dims.
"""
from __future__ import annotations

import numpy as np


def to_channels_last(x: np.ndarray) -> np.ndarray:
    """(C, *spatial) -> (*spatial, C)."""
    return np.moveaxis(x, 0, -1)


def to_channels_first(x: np.ndarray) -> np.ndarray:
    """(*spatial, C) -> (C, *spatial)."""
    return np.moveaxis(x, -1, 0)


def batch_channel_add(x: np.ndarray) -> np.ndarray:
    """(*spatial,) -> (1, *spatial, 1)."""
    return x[None, ..., None]


def batch_channel_del(x: np.ndarray) -> np.ndarray:
    """(1, *spatial, 1) -> (*spatial,)."""
    return np.squeeze(np.squeeze(x, axis=0), axis=-1)


def nchw_to_nhwc(x: np.ndarray) -> np.ndarray:
    """Batched channels-first -> channels-last (any spatial rank)."""
    return np.moveaxis(x, 1, -1)


def nhwc_to_nchw(x: np.ndarray) -> np.ndarray:
    """Batched channels-last -> channels-first (any spatial rank)."""
    return np.moveaxis(x, -1, 1)
