"""Norm-free dilated ResNet18 feature extractor (DenseFusion variant).

Port of ``morefusion_tpu/models/resnet.py::DilatedResNet18``: bias-free
3x3 convs, no normalization, res4/res5 at stride 1 with dilation 2/4, so the
output is at 1/8 resolution with ``8 * base_width`` channels. Submodule
names follow the flax parameter tree, so converted weights load by name.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
import torch.nn.functional as F

MEAN_RGB = (0.485, 0.456, 0.406)
STD_RGB = (0.229, 0.224, 0.225)


def normalize_rgb(x: torch.Tensor) -> torch.Tensor:
    """uint8-range ``(..., 3)`` RGB -> ImageNet-normalized float32."""
    mean = torch.tensor(MEAN_RGB, dtype=torch.float32, device=x.device)
    std = torch.tensor(STD_RGB, dtype=torch.float32, device=x.device)
    return (x.to(torch.float32) / 255.0 - mean) / std


class BasicBlock(nn.Module):
    def __init__(self, in_channels, out_channels, stride=1, dilate=1,
                 residual_conv=False):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, out_channels, 3, stride=stride,
                                padding=dilate, dilation=dilate, bias=False)
        self.Conv_1 = nn.Conv2d(out_channels, out_channels, 3,
                                padding=dilate, dilation=dilate, bias=False)
        self.Conv_2 = (
            nn.Conv2d(in_channels, out_channels, 1, stride=stride, bias=False)
            if residual_conv else None
        )

    def forward(self, x):
        h = F.relu(self.Conv_0(x))
        h = self.Conv_1(h)
        residual = x if self.Conv_2 is None else self.Conv_2(x)
        return F.relu(h + residual)


class ResBlock(nn.Module):
    def __init__(self, n_layer, in_channels, out_channels, stride, dilate,
                 residual_conv=True):
        super().__init__()
        blocks = [BasicBlock(in_channels, out_channels, stride=stride,
                             dilate=1, residual_conv=residual_conv)]
        blocks += [BasicBlock(out_channels, out_channels, dilate=dilate)
                   for _ in range(n_layer - 1)]
        for i, block in enumerate(blocks):
            self.add_module(f"BasicBlock_{i}", block)
        self._n = n_layer

    def forward(self, x):
        for i in range(self._n):
            x = getattr(self, f"BasicBlock_{i}")(x)
        return x


class DilatedResNet18(nn.Module):
    """``(B, H, W, 3)`` uint8-range RGB -> ``(B, 8w, H/8, W/8)`` (NCHW)."""

    def __init__(self, base_width: int = 64,
                 blocks: Sequence[int] = (2, 2, 2, 2)):
        super().__init__()
        w = base_width
        self.Conv_0 = nn.Conv2d(3, w, 7, stride=2, padding=3, bias=False)
        self.ResBlock_0 = ResBlock(blocks[0], w, w, 1, 1, residual_conv=False)
        self.ResBlock_1 = ResBlock(blocks[1], w, w * 2, 2, 1)
        self.ResBlock_2 = ResBlock(blocks[2], w * 2, w * 4, 1, 2)
        self.ResBlock_3 = ResBlock(blocks[3], w * 4, w * 8, 1, 4)

    def forward(self, rgb):
        h = normalize_rgb(rgb).permute(0, 3, 1, 2)
        h = self.Conv_0(h)
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        h = self.ResBlock_0(h)
        h = self.ResBlock_1(h)
        h = self.ResBlock_2(h)
        return self.ResBlock_3(h)
