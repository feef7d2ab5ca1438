"""Noise tensors from explicit ``torch.Generator``s (counterpart of ``ops/noise.py``).

Statistics match the JAX package; the bit streams do not (a JAX key and a
torch generator seeded alike draw different numbers), so parity tests hand
both packages the same numpy noise.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch


def get_noise(generator: Optional[torch.Generator], shape: Sequence[int],
              dist: str = "n", dtype: torch.dtype = torch.float32,
              device: Optional[torch.device] = None) -> torch.Tensor:
    """Noise tensor of ``shape``; ``dist`` in {'n', 'u', 'c'}.

    'n' is N(0,1), 'u' is U[0,1), 'c' a standard Cauchy (median 0, scale 1,
    drawn as tan(pi*(u-1/2)) like ``jax.random.cauchy``). 'n' and 'u' are
    drawn in ``dtype`` directly, as ``jax.random`` does, which keeps a
    float32 copy of the flagship canvas out of device memory.
    """
    shape = tuple(shape)
    if dist == "n":
        return torch.randn(shape, generator=generator, device=device, dtype=dtype)
    if dist == "u":
        return torch.rand(shape, generator=generator, device=device, dtype=dtype)
    if dist == "c":
        u = torch.rand(shape, generator=generator, device=device)
        return torch.tan(math.pi * (u - 0.5)).to(dtype)
    raise ValueError("noise_dist has to be one of [u, n, c]")


def data_forgetting_weights(factor: int) -> np.ndarray:
    """Log-spaced 1 -> 1e-4 ramp over ``factor`` iterations."""
    if factor <= 0:
        return np.zeros((0,), np.float32)
    return np.logspace(0, -4, factor).astype(np.float32)


def build_forgetting_data(img_masked: torch.Tensor, inputdepth: int) -> torch.Tensor:
    """The decimated data (N, C, *spatial) tiled along channels to
    ``inputdepth`` channels; the caller normalises its std."""
    reps = -(-inputdepth // img_masked.shape[1])  # ceil
    tiled = img_masked.repeat((1, reps) + (1,) * (img_masked.ndim - 2))
    return tiled[:, :inputdepth]

