"""Ops of the PyTorch port: losses, noise, the conv with its weight-gradient
kernel, and the fused loss/metrics kernel."""
from .conv_vjp import conv_same
from .fused_loss import fused_loss_metrics
from .losses import (get_loss_fn, mae, masked_mae, masked_mse, mse, pcorr,
                     snr)
from .noise import get_noise
from .wgrad import wgrad3d, wgrad_supported

__all__ = ["conv_same", "fused_loss_metrics", "get_loss_fn", "get_noise",
           "mae", "masked_mae", "masked_mse", "mse", "pcorr", "snr",
           "wgrad3d", "wgrad_supported"]
