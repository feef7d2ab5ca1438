"""Models of the PyTorch port and the ``get_net`` factory.

Only the flagship MulResUnet (2D and 3D) is ported; every other net of the
JAX package's zoo raises ``NotImplementedError`` (ROADMAP A.10).
"""
from __future__ import annotations

import torch

from ..config import Config
from .blocks import (Conv, ConvNormAct, Dropout, Norm, concat_crop,
                     get_activation, upsample)
from .init import init_weights
from .mulresunet import MulResUnet, MultiResBlock, ResPath, multires_width

__all__ = ["get_net", "init_weights", "MulResUnet", "MultiResBlock", "ResPath",
           "multires_width", "Conv", "ConvNormAct", "Norm", "Dropout",
           "concat_crop", "get_activation", "upsample"]


def get_net(cfg: Config, outchannel: int = 1) -> MulResUnet:
    """Map (datadim, net) to a module whose input has ``cfg.inputdepth``
    channels. 'multiunet' and 'load' build the MulResUnet."""
    if cfg.net not in ("multiunet", "load"):
        raise NotImplementedError(f"net '{cfg.net}' is not ported yet: ROADMAP A.10")
    return MulResUnet(
        in_channels=cfg.inputdepth, out_channels=outchannel, ndim=cfg.ndim_model,
        filters=tuple(cfg.filters), skip=tuple(cfg.skip), act=cfg.activation,
        last_act=cfg.last_activation, use_bias=True, upsample_mode=cfg.upsample,
        dropout=cfg.dropout,
        dtype=torch.bfloat16 if cfg.dtype == "bfloat16" else None,
        remat=cfg.remat, phase_space=cfg.phase_space and cfg.phase_levels != 0)
