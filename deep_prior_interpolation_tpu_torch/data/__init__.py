"""Data of the PyTorch port: synthetic volumes and masks."""
from .synthetic import flagship_problem, hyperbolic_events, random_trace_mask

__all__ = ["flagship_problem", "hyperbolic_events", "random_trace_mask"]
