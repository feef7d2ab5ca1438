"""Generic helpers of the PyTorch port."""
from .generic import nextpow2, ten_digit

__all__ = ["nextpow2", "ten_digit"]
