"""Small generic helpers (counterpart of ``deep_prior_interpolation_tpu.utils.generic``).

Only what the ported slice uses: digit widths for the history log and the
power-of-two helper.
"""
from __future__ import annotations

import math


def nextpow2(x: float) -> int:
    """Smallest integer p such that 2**p >= x."""
    if x <= 1:
        return 0
    return int(math.ceil(math.log2(x)))


def ten_digit(number: float) -> int:
    """Number of decimal digits needed to print indices up to ``number``."""
    if number <= 1:
        return 1
    return int(math.floor(math.log10(number)) + 1)
