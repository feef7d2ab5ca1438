"""Ops of the PyTorch port: losses, noise, the conv with its weight-gradient
kernel, the fused loss/metrics kernel, the POCS projection, masks and
``bool2bin``."""
from .conv_vjp import conv_same
from .filters import bool2bin
from .fused_loss import fused_loss_metrics
from .losses import (get_loss_fn, mae, masked_mae, masked_mse, mse, pcorr,
                     snr)
from .masks import MaskUpdate, add_rand_mask, build_mask, dilate_mask
from .noise import get_noise
from .pocs import POCS, compute_threshold, fk_projection, pocs_fk_fn, threshold
from .wgrad import wgrad3d, wgrad_supported

__all__ = ["MaskUpdate", "POCS", "add_rand_mask", "bool2bin", "build_mask",
           "compute_threshold", "conv_same", "dilate_mask", "fk_projection",
           "fused_loss_metrics", "get_loss_fn", "get_noise", "mae", "masked_mae",
           "masked_mse", "mse", "pcorr", "pocs_fk_fn", "snr", "threshold",
           "wgrad3d", "wgrad_supported"]
