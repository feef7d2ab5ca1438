"""Losses and reconstruction metrics (counterpart of ``ops/losses.py``).

The masked data fit takes the mean over *all* elements, not only the
observed ones; ``snr`` is in dB; ``pcorr`` is the two-pass Pearson
correlation. All functions are layout-agnostic reductions.
"""
from __future__ import annotations

import torch


def masked_mae(out: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean |out*mask - target*mask| over all elements."""
    return torch.mean(torch.abs((out - target) * mask))


def masked_mse(out: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean ((out-target)*mask)^2 over all elements."""
    d = (out - target) * mask
    return torch.mean(d * d)


def mae(out: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(out - target))


def mse(out: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    d = out - target
    return torch.mean(d * d)


def get_loss_fn(name: str):
    """'mae' (alias 'l1') -> masked L1, 'mse' -> masked L2."""
    if name == "mse":
        return masked_mse
    if name in ("mae", "l1"):
        return masked_mae
    raise ValueError(f"unknown loss '{name}'")


def snr(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Signal-to-noise ratio in dB."""
    num = torch.sum(target * target)
    den = torch.sum((target - output) ** 2)
    return 10.0 * torch.log10(num / den)


def pcorr(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Pearson correlation coefficient (two passes: means first)."""
    t = target - torch.mean(target)
    o = output - torch.mean(output)
    return torch.sum(t * o) / (torch.sqrt(torch.sum(t * t)) * torch.sqrt(torch.sum(o * o)))
