"""ConvGRU recurrent ensemble (counterpart of ``models/convgru.py``).

The orthogonally initialised convolutional GRU cell, a ResNet34-topology
encoder (3-4-6-3 basic blocks), the 5x upsample decoder and the recurrent
``Ensemble``: one shared step (GRU update, decode) rolled over the frames in
a Python loop, where the JAX package scans it. The step's parameters sit
under ``Scan_RolloutStep_0``, the name flax's ``nn.scan`` gives them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .blocks import Compact, Conv, ConvNormAct, FlaxConv, Norm, upsample


class ConvGRUCell(Compact):
    """Convolutional GRU cell, 2D: ``forward(x, state)`` is the next state."""

    def __init__(self, hidden: int, kernel_size: int = 3):
        super().__init__()
        self.hidden, self.kernel_size = hidden, kernel_size

    def _gate(self, h: torch.Tensor, name: str) -> torch.Tensor:
        return self.child("Conv", lambda: FlaxConv(h.shape[1], self.hidden, self.kernel_size,
                                                   ndim=2, init="orthogonal"), name=name)(h)

    def forward(self, x: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
        stacked = torch.cat([x, state], 1)
        update = torch.sigmoid(self._gate(stacked, "update_gate"))
        reset = torch.sigmoid(self._gate(stacked, "reset_gate"))
        out = torch.tanh(self._gate(torch.cat([x, state * reset], 1), "out_gate"))
        return state * (1 - update) + out * update


class ResNetBasicBlock(Compact):
    """ResNet34's basic block: conv3, conv3, identity or 1x1 projection."""

    def __init__(self, features: int, stride: int = 1):
        super().__init__()
        self.features, self.stride = features, stride

    def _conv(self, h, k, stride=1):
        return self.child("Conv", lambda: Conv(h.shape[1], self.features, k, stride=stride,
                                               ndim=2, use_bias=False))(h)

    def _norm(self, h):
        return self.child("Norm", lambda: Norm(h.shape[1]))(h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self._norm(self._conv(x, 3, self.stride)))
        h = self._norm(self._conv(h, 3))
        if self.stride != 1 or x.shape[1] != self.features:
            x = self._norm(self._conv(x, 1, self.stride))
        return F.relu(x + h)


class Encoder(Compact):
    """ResNet34-stem encoder: (N, C, H, W) -> (N, 512, H/32, W/32)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.child("Conv", lambda: Conv(x.shape[1], 64, 7, stride=2, ndim=2,
                                            use_bias=False))(x)
        h = F.relu(self.child("Norm", lambda: Norm(64))(h))
        h = F.max_pool2d(h, 3, 2, padding=1)
        for features, blocks, stride in [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]:
            for b in range(blocks):
                h = self.child("ResNetBasicBlock", lambda: ResNetBasicBlock(
                    features, stride if b == 0 else 1))(h)
        return h


class Decoder(Compact):
    """5x-upsample decoder: (N, C, h, w) -> (N, out_channels, 32h, 32w)."""

    def __init__(self, out_channels: int = 1, upsample_mode: str = "nearest"):
        super().__init__()
        self.out_channels, self.upsample_mode = out_channels, upsample_mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for f in [256, 128, 64, 32, 16]:
            x = self.child("ConvNormAct", lambda: ConvNormAct(x.shape[1], f, 3, ndim=2))(x)
            x = upsample(x, 2, self.upsample_mode)
        x = self.child("ConvNormAct", lambda: ConvNormAct(16, 16, 1, ndim=2))(x)
        return self.child("Conv", lambda: Conv(16, self.out_channels, 3, ndim=2))(x)


class _RolloutStep(Compact):
    """One frame: GRU state update, then decode."""

    def __init__(self, hidden: int, out_channels: int, upsample_mode: str):
        super().__init__()
        self.hidden, self.out_channels, self.upsample_mode = hidden, out_channels, upsample_mode

    def forward(self, feature: torch.Tensor, state: torch.Tensor):
        state = self.child("ConvGRUCell", lambda: ConvGRUCell(self.hidden))(feature, state)
        out = self.child("Decoder", lambda: Decoder(self.out_channels, self.upsample_mode))(state)
        return state, out


class Ensemble(Compact):
    """Recurrent encoder-GRU-decoder rollout, input (N, in_channels, H, W)
    with H, W divisible by 32; output (num_frames * N, out_channels, H, W),
    the frames stacked on the batch dim."""

    def __init__(self, in_channels: int, out_channels: int = 1, num_frames: int = 4,
                 hidden: int = 512, upsample_mode: str = "nearest"):
        super().__init__()
        self.out_channels, self.num_frames = out_channels, num_frames
        self.hidden, self.upsample_mode = hidden, upsample_mode
        self.build(torch.zeros((1, in_channels, 32, 32)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feature = self.child("Encoder", Encoder)(x)  # the same input every frame
        state = torch.zeros((feature.shape[0], self.hidden) + feature.shape[2:],
                            dtype=feature.dtype, device=feature.device)
        step = self.child("RolloutStep", lambda: _RolloutStep(
            self.hidden, self.out_channels, self.upsample_mode), name="Scan_RolloutStep_0")
        outs = []
        for _ in range(self.num_frames):
            state, out = step(feature, state)
            outs.append(out)
        return torch.cat(outs, 0)
