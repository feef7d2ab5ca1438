"""Generic helpers of the PyTorch port."""
from .generic import nextpow2, random_code, sec2time, ten_digit

__all__ = ["nextpow2", "random_code", "sec2time", "ten_digit"]
