"""Small generic helpers (counterpart of ``deep_prior_interpolation_tpu.utils.generic``).

The power-of-two helper, digit widths for the history log and the snapshot
names, run-id codes and the h:mm:ss formatting of run times and its inverse.
The JAX package's compile-cache switch has no counterpart here.
"""
from __future__ import annotations

import math
import secrets
import string


def nextpow2(x: float) -> int:
    """Smallest integer p such that 2**p >= x."""
    if x <= 1:
        return 0
    return int(math.ceil(math.log2(x)))


def random_code(n: int = 6) -> str:
    """A short alphanumeric run id."""
    alphabet = string.ascii_lowercase + string.digits
    return "".join(secrets.choice(alphabet) for _ in range(n))


def ten_digit(number: float) -> int:
    """Number of decimal digits needed to print indices up to ``number``."""
    if number <= 1:
        return 1
    return int(math.floor(math.log10(number)) + 1)


def sec2time(seconds: float) -> str:
    """Format seconds as ``h:mm:ss``."""
    s = int(round(seconds))
    h, rem = divmod(s, 3600)
    m, sec = divmod(rem, 60)
    return f"{h:d}:{m:02d}:{sec:02d}"


def time2sec(time_str: str) -> int:
    """Seconds of an ``h:mm:ss`` (or ``mm:ss``, ``ss``) string: the inverse
    of :func:`sec2time`."""
    parts = [int(p) for p in str(time_str).split(":")]
    while len(parts) < 3:
        parts.insert(0, 0)
    h, m, s = parts[-3:]
    return h * 3600 + m * 60 + s
