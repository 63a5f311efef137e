"""Dilated ResNet feature extractors (NCHW).

Port of ``morefusion_tpu/models/resnet.py``:

- ``DilatedResNet18`` / ``DilatedResNet34``: the norm-free DenseFusion
  ResNet, bias-free 3x3 convs, res4/res5 at stride 1 with dilation 2/4, so
  the output is at 1/8 resolution with ``8 * base_width`` channels. It
  computes in ``compute_dtype`` after the ImageNet normalization.
- ``ResNet18Extractor``: the torchvision ResNet18 layout with BatchNorm
  frozen on its running statistics (in training too) and no gradient below
  res3, the reference's pretrained backbone. It has no compute dtype: it
  runs in fp32 whatever the model around it computes in, as in JAX.

Submodule names follow the flax parameter tree, so converted weights load
by name.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
import torch.nn.functional as F

from ..utils.constants import device_constant
from .layers import Conv2d, FrozenBatchNorm2d

MEAN_RGB = (0.485, 0.456, 0.406)
STD_RGB = (0.229, 0.224, 0.225)


def normalize_rgb(x: torch.Tensor) -> torch.Tensor:
    """uint8-range ``(..., 3)`` RGB -> ImageNet-normalized float32."""
    mean = device_constant(MEAN_RGB, torch.float32, x.device)
    std = device_constant(STD_RGB, torch.float32, x.device)
    return (x.to(torch.float32) / 255.0 - mean) / std


def _nchw(rgb):
    # contiguous NCHW: a permuted (channels-last) input sends the CPU
    # backward through a oneDNN path that crashes with 3+ threads
    return normalize_rgb(rgb).permute(0, 3, 1, 2).contiguous()


class BasicBlock(nn.Module):
    def __init__(self, in_channels, out_channels, stride=1, dilate=1,
                 residual_conv=False, compute_dtype=torch.float32):
        super().__init__()
        dt = dict(compute_dtype=compute_dtype)
        self.Conv_0 = Conv2d(in_channels, out_channels, 3, stride=stride,
                             padding=dilate, dilation=dilate, bias=False,
                             **dt)
        self.Conv_1 = Conv2d(out_channels, out_channels, 3, padding=dilate,
                             dilation=dilate, bias=False, **dt)
        self.Conv_2 = (
            Conv2d(in_channels, out_channels, 1, stride=stride, bias=False,
                   **dt)
            if residual_conv else None
        )

    def forward(self, x):
        h = F.relu(self.Conv_0(x))
        h = self.Conv_1(h)
        residual = x if self.Conv_2 is None else self.Conv_2(x)
        return F.relu(h + residual)


class ResBlock(nn.Module):
    def __init__(self, n_layer, in_channels, out_channels, stride, dilate,
                 residual_conv=True, compute_dtype=torch.float32):
        super().__init__()
        dt = dict(compute_dtype=compute_dtype)
        blocks = [BasicBlock(in_channels, out_channels, stride=stride,
                             dilate=1, residual_conv=residual_conv, **dt)]
        blocks += [BasicBlock(out_channels, out_channels, dilate=dilate, **dt)
                   for _ in range(n_layer - 1)]
        for i, block in enumerate(blocks):
            self.add_module(f"BasicBlock_{i}", block)
        self._n = n_layer

    def forward(self, x):
        for i in range(self._n):
            x = getattr(self, f"BasicBlock_{i}")(x)
        return x


class DilatedResNet(nn.Module):
    """``(B, H, W, 3)`` uint8-range RGB -> ``(B, 8w, H/8, W/8)`` (NCHW), in
    ``compute_dtype``."""

    def __init__(self, blocks: Sequence[int], base_width: int = 64,
                 compute_dtype=torch.float32):
        super().__init__()
        w = base_width
        dt = dict(compute_dtype=compute_dtype)
        self.compute_dtype = compute_dtype
        self.Conv_0 = Conv2d(3, w, 7, stride=2, padding=3, bias=False, **dt)
        self.ResBlock_0 = ResBlock(blocks[0], w, w, 1, 1, residual_conv=False,
                                   **dt)
        self.ResBlock_1 = ResBlock(blocks[1], w, w * 2, 2, 1, **dt)
        self.ResBlock_2 = ResBlock(blocks[2], w * 2, w * 4, 1, 2, **dt)
        self.ResBlock_3 = ResBlock(blocks[3], w * 4, w * 8, 1, 4, **dt)

    def forward(self, rgb):
        h = self.Conv_0(_nchw(rgb).to(self.compute_dtype))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        h = self.ResBlock_0(h)
        h = self.ResBlock_1(h)
        h = self.ResBlock_2(h)
        return self.ResBlock_3(h)


class DilatedResNet18(DilatedResNet):
    def __init__(self, base_width: int = 64, **kw):
        super().__init__((2, 2, 2, 2), base_width, **kw)


class DilatedResNet34(DilatedResNet):
    def __init__(self, base_width: int = 64, **kw):
        super().__init__((3, 4, 6, 3), base_width, **kw)


class BNBasicBlock(nn.Module):
    """Basic block with frozen BatchNorm after each conv (and after the
    residual conv)."""

    def __init__(self, in_channels, out_channels, stride=1, dilate=1,
                 residual_conv=False):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, out_channels, 3, stride=stride,
                                padding=dilate, dilation=dilate, bias=False)
        self.BatchNorm_0 = FrozenBatchNorm2d(out_channels)
        self.Conv_1 = nn.Conv2d(out_channels, out_channels, 3, padding=dilate,
                                dilation=dilate, bias=False)
        self.BatchNorm_1 = FrozenBatchNorm2d(out_channels)
        if residual_conv:
            self.Conv_2 = nn.Conv2d(in_channels, out_channels, 1,
                                    stride=stride, bias=False)
            self.BatchNorm_2 = FrozenBatchNorm2d(out_channels)
        else:
            self.Conv_2 = None

    def forward(self, x):
        h = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        h = self.BatchNorm_1(self.Conv_1(h))
        residual = (x if self.Conv_2 is None
                    else self.BatchNorm_2(self.Conv_2(x)))
        return F.relu(h + residual)


# (in, out, stride, dilate, residual_conv) of BNBasicBlock_0 .. _7
_BN_BLOCKS = ((64, 64, 1, 1, False), (64, 64, 1, 1, False),
              (64, 128, 2, 1, True), (128, 128, 1, 1, False),
              (128, 256, 1, 1, True), (256, 256, 1, 2, False),
              (256, 512, 1, 1, True), (512, 512, 1, 4, False))


class ResNet18Extractor(nn.Module):
    """Frozen-BN dilated ResNet18, fp32: ``(B, H, W, 3)`` uint8-range RGB
    -> ``(B, 512, H/8, W/8)``. res2 and below are a fixed feature
    extractor: no gradient flows below res3."""

    def __init__(self):
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.BatchNorm_0 = FrozenBatchNorm2d(64)
        for i, (cin, cout, stride, dilate, res) in enumerate(_BN_BLOCKS):
            self.add_module(f"BNBasicBlock_{i}", BNBasicBlock(
                cin, cout, stride=stride, dilate=dilate, residual_conv=res))

    def forward(self, rgb):
        h = F.relu(self.BatchNorm_0(self.Conv_0(_nchw(rgb))))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        for i in range(len(_BN_BLOCKS)):
            if i == 2:
                h = h.detach()  # the reference unchains at res2
            h = getattr(self, f"BNBasicBlock_{i}")(h)
        return h
