"""Signal-processing ops (counterpart of ``ops/filters.py``).

Only ``bool2bin`` is ported: the data pipeline turns NaN-marked traces into
a binary mask with it. The wavelet and Butterworth shaping of the input
canvas, with the rest of that module, are still to port (ROADMAP A.7).
"""
from __future__ import annotations

import numpy as np


def bool2bin(x: np.ndarray, logic: bool = True) -> np.ndarray:
    """NaN-coded corrupted traces -> binary mask (0 at NaN when ``logic``)."""
    out = np.where(np.isnan(x), 0.0 if logic else 1.0, 1.0 if logic else 0.0)
    return out.astype(np.float32 if x.dtype.kind == "f" else x.dtype)
