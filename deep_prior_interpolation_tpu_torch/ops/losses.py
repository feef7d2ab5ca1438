"""Losses and reconstruction metrics (counterpart of ``ops/losses.py``).

The masked data fit takes the mean over *all* elements, not only the
observed ones; ``snr`` is in dB; ``pcorr`` is the two-pass Pearson
correlation. All functions are layout-agnostic reductions.

``masked_fit`` and ``snr_pcorr`` compute them from sums over the pieces of
a volume (the shards of a spatially sharded one), each total taken by
``total``; a whole volume is one piece, its total the piece's own sum.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

Total = Callable[[Sequence[torch.Tensor]], torch.Tensor]


def _whole(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The total of a volume that is one piece."""
    (part,) = parts
    return part


def masked_fit_sum(out: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                   name: str) -> torch.Tensor:
    """The sum of |d| ('mae', alias 'l1') or d * d ('mse') of
    d = (out - target) * mask."""
    if name not in ("mae", "l1", "mse"):
        raise ValueError(f"unknown loss '{name}'")
    d = (out - target) * mask
    return torch.sum(d * d) if name == "mse" else torch.sum(torch.abs(d))


def masked_fit(outs: Sequence[torch.Tensor], targets: Sequence[torch.Tensor],
               masks: Sequence[torch.Tensor], name: str, total: Total = _whole
               ) -> torch.Tensor:
    """The masked loss ``name`` of the volume in pieces: the pieces' sums,
    totalled, over the volume's element count."""
    n = float(sum(o.numel() for o in outs))
    return total([masked_fit_sum(o, t, m, name) for o, t, m in zip(outs, targets, masks)]) / n


def snr_pcorr(outs: Sequence[torch.Tensor], targets: Sequence[torch.Tensor],
              total: Total = _whole) -> Dict[str, torch.Tensor]:
    """{'snr', 'pcorr'} of the volume in pieces: the signal and residual
    energies, then the means, then the centred products, each totalled."""
    n = float(sum(o.numel() for o in outs))
    num = total([torch.sum(t * t) for t in targets])
    den = total([torch.sum((t - o) ** 2) for o, t in zip(outs, targets)])
    mt = total([torch.sum(t) for t in targets]) / n
    mo = total([torch.sum(o) for o in outs]) / n
    ts = [t - mt.to(t.device) for t in targets]
    os_ = [o - mo.to(o.device) for o in outs]
    cov = total([torch.sum(t * o) for o, t in zip(os_, ts)])
    vt = total([torch.sum(t * t) for t in ts])
    vo = total([torch.sum(o * o) for o in os_])
    return {"snr": 10.0 * torch.log10(num / den),
            "pcorr": cov / (torch.sqrt(vt) * torch.sqrt(vo))}


def masked_mae(out: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean |out*mask - target*mask| over all elements."""
    return masked_fit([out], [target], [mask], "mae")


def masked_mse(out: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean ((out-target)*mask)^2 over all elements."""
    return masked_fit([out], [target], [mask], "mse")


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
    return snr_pcorr([output], [target])["snr"]


def pcorr(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Pearson correlation coefficient (two passes: means first)."""
    return snr_pcorr([output], [target])["pcorr"]
