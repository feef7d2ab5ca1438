"""Models of the PyTorch port and the ``get_net`` factory.

The JAX package's whole zoo: the flagship MulResUnet (2D and 3D), the skip
net, the U-Net, the partial-conv U-Net, the attention nets and the ConvGRU
ensemble. Every net takes its input's channel count at construction, and
its parameters carry the flax module's names (``io/bridge.py``).
"""
from __future__ import annotations

import torch
from torch import nn

from ..config import Config
from .attention import (AttMulResUnet, AttentionUnet, CBAM, ChannelGate,
                        GridAttentionBlock, SpatialGate)
from .blocks import (Compact, Conv, ConvNormAct, ConvTranspose, Dense, Dropout,
                     FlaxConv, Norm, concat_crop, downsample_pool, get_activation,
                     lanczos_downsample, lanczos_kernel_1d, resample_kernel_1d,
                     set_dropout_generator, symmetry, upsample)
from .convgru import ConvGRUCell, Decoder, Encoder, Ensemble, ResNetBasicBlock
from .init import init_weights
from .mulresunet import MulResUnet, MultiResBlock, ResPath, multires_width
from .partial import PartialBlock, PartialConv, PartialUNet
from .skip import SkipNet
from .unet import InstanceNorm, UNet, UNetConv

__all__ = [
    "get_net", "init_weights", "MulResUnet", "MultiResBlock", "ResPath",
    "multires_width", "Compact", "Conv", "ConvNormAct", "ConvTranspose", "Dense",
    "Dropout", "FlaxConv", "Norm", "concat_crop", "downsample_pool", "get_activation",
    "lanczos_downsample", "lanczos_kernel_1d", "resample_kernel_1d",
    "set_dropout_generator", "symmetry", "upsample", "SkipNet", "AttMulResUnet",
    "AttentionUnet", "CBAM", "ChannelGate", "GridAttentionBlock", "SpatialGate",
    "PartialBlock", "PartialConv", "PartialUNet", "InstanceNorm", "UNet", "UNetConv",
    "ConvGRUCell", "Decoder", "Encoder", "Ensemble", "ResNetBasicBlock",
]


def get_net(cfg: Config, outchannel: int = 1) -> nn.Module:
    """Map (datadim, net) to a module whose input has ``cfg.inputdepth``
    channels, as the JAX package's factory does: 'multiunet' and 'load' the
    MulResUnet (the only net that takes ``dtype``; the others compute in
    their input's), 'skip', 'attmultiunet' (2D only), 'part', 'unet'."""
    ndim, name, cin = cfg.ndim_model, cfg.net, cfg.inputdepth
    common = dict(out_channels=outchannel, ndim=ndim, act=cfg.activation,
                  last_act=cfg.last_activation, use_bias=True,
                  upsample_mode=cfg.upsample, dropout=cfg.dropout)
    if name in ("multiunet", "load"):
        return MulResUnet(
            cin, filters=tuple(cfg.filters), skip=tuple(cfg.skip),
            dtype=torch.bfloat16 if cfg.dtype == "bfloat16" else None, remat=cfg.remat,
            remat_levels=cfg.remat_levels or None,
            phase_space=cfg.phase_space and cfg.phase_levels != 0,
            phase_levels=None if cfg.phase_levels < 0 else cfg.phase_levels,
            phase_deep_levels=cfg.phase_deep_levels, **common)
    if name == "skip":
        return SkipNet(cin, filters=tuple(cfg.filters), skip=tuple(cfg.skip), **common)
    if name == "attmultiunet":
        if ndim != 2:
            raise ValueError("attmultiunet is 2D-only")
        return AttMulResUnet(cin, filters=tuple(cfg.filters), **common)
    if name == "part":
        common.pop("upsample_mode")
        common.pop("last_act")
        return PartialUNet(cin, **common)
    if name == "unet":
        return UNet(cin, filters=tuple(cfg.filters), **common)
    raise ValueError(f"unknown net '{name}'")
