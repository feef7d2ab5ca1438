"""Ops of the PyTorch port: losses, noise, the conv with its weight-gradient
kernel, the fused loss/metrics kernel, the linear upsample with its
backward kernel, the POCS projection, masks, the signal-processing filters,
linear operators and slopes; the kernels' lane-batched forms
(``*_lanes``) serve a batch of patches."""
from .conv_vjp import conv_same
from .filters import (bool2bin, convolve_kernel_1d, denormalize, first_derivative,
                      gaussian_filter, gaussian_kernel, lowpass_butterworth_taps,
                      normalize, ricker_wavelet, second_derivative)
from .fused_loss import fused_loss_metrics, fused_sums_lanes, loss_sums_grad_lanes
from .linops import (LinearOperator, auto_adjoint, avo_modelling, chain, dottest,
                     hessian, vertical_conv, vertical_grad)
from .losses import (get_loss_fn, mae, masked_mae, masked_mse, mse, pcorr,
                     snr)
from .masks import MaskUpdate, add_rand_mask, build_mask, dilate_mask
from .noise import build_forgetting_data, data_forgetting_weights, get_noise
from .pocs import POCS, compute_threshold, fk_projection, pocs_fk_fn, threshold
from .slopes import Hale2D, directional_laplacian, structure_tensor_dips
from .upsample import linear_upsample2x, upsample_bwd
from .wgrad import wgrad3d, wgrad3d_lanes, wgrad_supported

__all__ = ["Hale2D", "LinearOperator", "MaskUpdate", "POCS", "add_rand_mask",
           "auto_adjoint", "avo_modelling", "bool2bin", "build_forgetting_data",
           "build_mask", "chain", "compute_threshold", "conv_same", "convolve_kernel_1d",
           "data_forgetting_weights", "denormalize", "dilate_mask", "directional_laplacian",
           "dottest", "first_derivative", "fk_projection", "fused_loss_metrics", "fused_sums_lanes",
           "gaussian_filter", "gaussian_kernel", "get_loss_fn", "get_noise", "hessian",
           "linear_upsample2x", "loss_sums_grad_lanes", "lowpass_butterworth_taps", "mae", "masked_mae",
           "masked_mse", "mse", "normalize", "pcorr", "pocs_fk_fn", "ricker_wavelet",
           "second_derivative", "snr", "structure_tensor_dips", "threshold",
           "upsample_bwd", "vertical_conv", "vertical_grad", "wgrad3d", "wgrad3d_lanes",
           "wgrad_supported"]
