"""Per-point pose heads (rot / trans / conf towers) and class selection.

Port of ``morefusion_tpu/models/heads.py``. The hidden layers compute in
``compute_dtype``. The ``*_out`` layers have no compute dtype in JAX, so
flax promotes their bf16 input to their fp32 parameters: they and the
sigmoid compute in fp32, and so do the outputs.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from .layers import Linear


class PoseHeads(nn.Module):
    """``(B, P, C)`` point features -> per-class quaternions
    ``(B, P, n_fg_class, 4)``, translation offsets ``(B, P, n_fg_class, 3)``
    and confidences ``(B, P, n_fg_class)`` in (0, 1)."""

    def __init__(self, in_channels, n_fg_class, widths=(640, 256, 128),
                 compute_dtype=torch.float32):
        super().__init__()
        self.n_fg_class = n_fg_class
        self._widths = tuple(widths)
        for name, out_dim in (("rot", 4), ("trans", 3), ("conf", 1)):
            dims = (in_channels, *widths)
            for i in range(len(widths)):
                self.add_module(f"{name}_fc{i + 1}", Linear(
                    dims[i], dims[i + 1], compute_dtype=compute_dtype))
            self.add_module(f"{name}_out",
                            Linear(widths[-1], n_fg_class * out_dim))

    def _tower(self, h, name):
        for i in range(len(self._widths)):
            h = F.relu(getattr(self, f"{name}_fc{i + 1}")(h))
        return getattr(self, f"{name}_out")(h)

    def forward(self, feat):
        B, P, _ = feat.shape
        n = self.n_fg_class
        cls_rot = self._tower(feat, "rot").reshape(B, P, n, 4)
        cls_trans = self._tower(feat, "trans").reshape(B, P, n, 3)
        cls_conf = torch.sigmoid(self._tower(feat, "conf"))
        return cls_rot, cls_trans, cls_conf


def select_class(cls_rot, cls_trans, cls_conf, fg_class_id):
    """Each sample's own class channel: rot ``(B, P, 4)`` L2-normalized,
    trans ``(B, P, 3)``, conf ``(B, P)``; ``fg_class_id (B,)`` zero-based."""
    B = cls_rot.shape[0]
    bidx = torch.arange(B, device=cls_rot.device)
    rot = cls_rot[bidx, :, fg_class_id]
    trans = cls_trans[bidx, :, fg_class_id]
    conf = cls_conf[bidx, :, fg_class_id]
    rot = rot / torch.linalg.norm(rot, dim=-1, keepdim=True)
    return rot, trans, conf
