"""Ops of the PyTorch port: losses, noise, the conv with its weight-gradient
kernel, the fused loss/metrics kernel, the POCS projection, masks and the
signal-processing filters."""
from .conv_vjp import conv_same
from .filters import (bool2bin, convolve_kernel_1d, denormalize, first_derivative,
                      gaussian_filter, gaussian_kernel, lowpass_butterworth_taps,
                      normalize, ricker_wavelet, second_derivative)
from .fused_loss import fused_loss_metrics
from .losses import (get_loss_fn, mae, masked_mae, masked_mse, mse, pcorr,
                     snr)
from .masks import MaskUpdate, add_rand_mask, build_mask, dilate_mask
from .noise import build_forgetting_data, data_forgetting_weights, get_noise
from .pocs import POCS, compute_threshold, fk_projection, pocs_fk_fn, threshold
from .wgrad import wgrad3d, wgrad_supported

__all__ = ["MaskUpdate", "POCS", "add_rand_mask", "bool2bin", "build_forgetting_data",
           "build_mask", "compute_threshold", "conv_same", "convolve_kernel_1d",
           "data_forgetting_weights", "denormalize", "dilate_mask", "first_derivative",
           "fk_projection", "fused_loss_metrics", "gaussian_filter", "gaussian_kernel",
           "get_loss_fn", "get_noise", "lowpass_butterworth_taps", "mae", "masked_mae",
           "masked_mse", "mse", "normalize", "pcorr", "pocs_fk_fn", "ricker_wavelet",
           "second_derivative", "snr", "threshold", "wgrad3d", "wgrad_supported"]
