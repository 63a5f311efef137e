"""PSPNet pixel-feature extractor.

Port of ``morefusion_tpu/models/pspnet.py``: pyramid pooling at (1, 2, 3, 6)
over the 1/8-resolution backbone feature, a bottleneck, three x2 bilinear
upsampling stages, a 1x1 head and a log-softmax over channels. Bilinear
resizing is ``F.interpolate(align_corners=False)``, which matches
``jax.image.resize(..., "bilinear")`` when upsampling, the only way it is
used here; on the card ``ops.resize`` computes it with a hand-written CUDA
kernel, forward and backward. Dropout at 0.3, 0.15 and 0.15 after the
pyramid and the first two upsampling stages is on only in training, with
masks drawn from an explicit ``torch.Generator``. The convolutions compute
in ``compute_dtype``; the log-softmax runs in fp32. NCHW throughout.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from ..ops.resize import resize_bilinear
from .layers import Conv2d, PReLU


# rates after the pyramid module and the first two upsampling stages
DROPOUT_RATES = (0.3, 0.15, 0.15)


def dropout(x, rate: float, generator: torch.Generator):
    """Keep each element with probability ``1 - rate`` and scale it by
    ``1 / (1 - rate)`` (flax's ``nn.Dropout``); the mask comes from
    ``generator``, on ``x``'s device."""
    keep_prob = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, device=x.device,
                   dtype=x.dtype)
    return torch.where(u < keep_prob, x / keep_prob, torch.zeros_like(x))


class PSPModule(nn.Module):
    def __init__(self, in_channels, out_channels=1024,
                 sizes: Sequence[int] = (1, 2, 3, 6),
                 compute_dtype=torch.float32):
        super().__init__()
        self._sizes = tuple(sizes)
        dt = dict(compute_dtype=compute_dtype)
        for i in range(len(sizes)):
            self.add_module(f"Conv_{i}", Conv2d(in_channels, in_channels, 1,
                                                bias=False, **dt))
        self.add_module(f"Conv_{len(sizes)}", Conv2d(
            in_channels * (len(sizes) + 1), out_channels, 1, **dt))

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
    def __init__(self, in_channels, out_channels, compute_dtype=torch.float32):
        super().__init__()
        self.Conv_0 = Conv2d(in_channels, out_channels, 3, padding=1,
                             compute_dtype=compute_dtype)
        self.PReLU_0 = PReLU()

    def forward(self, x):
        _, _, H, W = x.shape
        return self.PReLU_0(self.Conv_0(resize_bilinear(x, H * 2, W * 2)))


class PSPNetExtractor(nn.Module):
    """``(B, C, H/8, W/8)`` -> ``(B, out_channels, H, W)`` log-probabilities."""

    def __init__(self, in_channels=512, out_channels=32,
                 bottleneck_channels=1024,
                 up_channels: Sequence[int] = (256, 64, 64),
                 compute_dtype=torch.float32):
        super().__init__()
        dt = dict(compute_dtype=compute_dtype)
        self.PSPModule_0 = PSPModule(in_channels, bottleneck_channels, **dt)
        widths = (bottleneck_channels, *up_channels)
        for i in range(3):
            self.add_module(f"PSPUpsample_{i}",
                            PSPUpsample(widths[i], widths[i + 1], **dt))
        self.Conv_0 = Conv2d(up_channels[2], out_channels, 1, **dt)

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """With ``train``, dropout draws its masks from ``generator``."""
        if train and generator is None:
            raise ValueError("train=True needs a generator for the dropout")
        h = self.PSPModule_0(x)
        for i, rate in enumerate(DROPOUT_RATES):
            if train:
                h = dropout(h, rate, generator)
            h = getattr(self, f"PSPUpsample_{i}")(h)
        return F.log_softmax(self.Conv_0(h).to(torch.float32), dim=1)
