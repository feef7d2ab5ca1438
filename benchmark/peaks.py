"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
700 W power limit): the divisors of every roofline share and of ``mfu``.
A card set below 700 W runs slower under load; a run prints its limit."""
from __future__ import annotations

FLOPS = {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12, "fp32": 67e12}
BYTES_PER_S = 3.35e12


def bound_s(flops: float, n_bytes: float, peak: str) -> float:
    """The least time the card could take: the larger of operations over the
    peak rate and bytes over the peak bandwidth."""
    return max(flops / FLOPS[peak], n_bytes / BYTES_PER_S)
