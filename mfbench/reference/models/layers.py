"""Layers that compute in a given dtype while their parameters stay fp32.

flax's ``dtype=`` on a ``Conv`` or ``Dense`` casts the input and the
parameters to that dtype, computes the product there, rounds it, and then
adds the bias in that dtype. These layers do the same with
``compute_dtype``. At fp32 they are the stock PyTorch layers, bias fused,
so an fp32 model computes exactly what it computed before. The frozen
BatchNorm uses flax's epsilon.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

BN_EPS = 1e-5  # flax's BatchNorm epsilon


def _cast_forward(layer, x, product, channels_first):
    dt = layer.compute_dtype
    if dt == torch.float32 and x.dtype == torch.float32:
        return product(x, layer.weight, layer.bias)
    y = product(x.to(dt), layer.weight.to(dt), None)
    if layer.bias is None:
        return y
    bias = layer.bias.to(dt)
    if channels_first:
        bias = bias.reshape(-1, *([1] * (y.dim() - 2)))
    return y + bias


class _Cast:
    def __init__(self, *args, compute_dtype=torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype


class Conv2d(_Cast, nn.Conv2d):
    def forward(self, x):
        return _cast_forward(self, x, self._conv_forward, True)


class Conv3d(_Cast, nn.Conv3d):
    def forward(self, x):
        return _cast_forward(self, x, self._conv_forward, True)


class Linear(_Cast, nn.Linear):
    def forward(self, x):
        return _cast_forward(self, x, F.linear, False)


class PReLU(nn.PReLU):
    """flax's PReLU: one fp32 slope, applied in the input's dtype."""

    def __init__(self):
        super().__init__(1, init=0.01)

    def forward(self, x):
        return F.prelu(x, self.weight.to(x.dtype))


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm on its running statistics only, in training too (flax's
    ``use_running_average=True``), with flax's epsilon."""

    def __init__(self, channels):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=False,
                            eps=BN_EPS)
