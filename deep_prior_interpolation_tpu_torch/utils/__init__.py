"""Generic helpers of the PyTorch port: number and time formatting, run
ids, numpy layout converters and the plots (``utils.plotting``, which needs
matplotlib only when a plot is drawn)."""
from .generic import nextpow2, random_code, sec2time, ten_digit, time2sec
from .layout import (batch_channel_add, batch_channel_del, nchw_to_nhwc,
                     nhwc_to_nchw, to_channels_first, to_channels_last)

__all__ = ["nextpow2", "random_code", "sec2time", "ten_digit", "time2sec",
           "batch_channel_add", "batch_channel_del", "nchw_to_nhwc", "nhwc_to_nchw",
           "to_channels_first", "to_channels_last"]
