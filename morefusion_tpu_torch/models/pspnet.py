"""PSPNet pixel-feature extractor.

Port of ``morefusion_tpu/models/pspnet.py``: pyramid pooling at (1, 2, 3, 6)
over the 1/8-resolution backbone feature, a bottleneck, three x2 bilinear
upsampling stages, a 1x1 head and a log-softmax over channels. Bilinear
resizing is ``F.interpolate(align_corners=False)``, which matches
``jax.image.resize(..., "bilinear")`` when upsampling, the only way it is
used here. Dropout is off at serving and is left out. NCHW throughout.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
import torch.nn.functional as F


def resize_bilinear(x, h, w):
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)


class PSPModule(nn.Module):
    def __init__(self, in_channels, out_channels=1024,
                 sizes: Sequence[int] = (1, 2, 3, 6)):
        super().__init__()
        self._sizes = tuple(sizes)
        for i in range(len(sizes)):
            self.add_module(f"Conv_{i}",
                            nn.Conv2d(in_channels, in_channels, 1, bias=False))
        self.add_module(f"Conv_{len(sizes)}", nn.Conv2d(
            in_channels * (len(sizes) + 1), out_channels, 1))

    def forward(self, x):
        _, _, H, W = x.shape
        hs = []
        for i, size in enumerate(self._sizes):
            kh, kw = max(1, H // size), max(1, W // size)
            h = F.avg_pool2d(x, (kh, kw), stride=(kh, kw))
            h = getattr(self, f"Conv_{i}")(h)
            hs.append(resize_bilinear(h, H, W))
        hs.append(x)
        h = getattr(self, f"Conv_{len(self._sizes)}")(torch.cat(hs, dim=1))
        return F.relu(h)


class PSPUpsample(nn.Module):
    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        # flax's PReLU has one scalar slope
        self.PReLU_0 = nn.PReLU(1, init=0.01)

    def forward(self, x):
        _, _, H, W = x.shape
        return self.PReLU_0(self.Conv_0(resize_bilinear(x, H * 2, W * 2)))


class PSPNetExtractor(nn.Module):
    """``(B, C, H/8, W/8)`` -> ``(B, out_channels, H, W)`` log-probabilities."""

    def __init__(self, in_channels=512, out_channels=32,
                 bottleneck_channels=1024,
                 up_channels: Sequence[int] = (256, 64, 64)):
        super().__init__()
        self.PSPModule_0 = PSPModule(in_channels, bottleneck_channels)
        widths = (bottleneck_channels, *up_channels)
        for i in range(3):
            self.add_module(f"PSPUpsample_{i}",
                            PSPUpsample(widths[i], widths[i + 1]))
        self.Conv_0 = nn.Conv2d(up_channels[2], out_channels, 1)

    def forward(self, x):
        h = self.PSPModule_0(x)
        h = self.PSPUpsample_0(h)
        h = self.PSPUpsample_1(h)
        h = self.PSPUpsample_2(h)
        return F.log_softmax(self.Conv_0(h).to(torch.float32), dim=1)
