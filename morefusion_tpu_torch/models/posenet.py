"""PoseNet: the DenseFusion-style point-cloud baseline (singleview_pcd).

Port of ``morefusion_tpu/models/posenet.py``: the flagship's 2D extractors
(DilatedResNet18, or with ``pretrained_resnet18`` the frozen-BN
``ResNet18Extractor``, then PSPNet) give per-pixel 32-channel features;
``n_point`` masked pixels are sampled per instance; a PointNet-style tower
(``PoseNetExtractor``) builds 128 + 256 per-point channels and a 1024-d
global mean broadcast back to every point (1408 in all); per-class heads
give per-point poses. No voxelization, so no ``voxel_dim`` and no
``pitch``. fp32 throughout (the JAX model has no compute dtype).
Submodule names follow the flax parameter tree (see ``convert_jax.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from ..utils.profiling import annotate
from .heads import PoseHeads, select_class
from .layers import Linear
from .pspnet import PSPNetExtractor
from .resnet import DilatedResNet18, ResNet18Extractor
from .sampling import gather_pixels, masked_median, sample_mask_indices

FEATURE_CHANNELS = 128 + 256 + 1024


class PoseNetExtractor(nn.Module):
    """``h_rgb (B, P, 32)``, ``pcd (B, P, 3)`` -> ``(B, P, 1408)``: two
    rgb / pcd Dense pairs (64, 128), then Dense 512 and 1024 on the second
    pair, whose mean over the points is broadcast back to each point."""

    def __init__(self):
        super().__init__()
        self.Dense_0 = Linear(32, 64)
        self.Dense_1 = Linear(3, 64)
        self.Dense_2 = Linear(64, 128)
        self.Dense_3 = Linear(64, 128)
        self.Dense_4 = Linear(256, 512)
        self.Dense_5 = Linear(512, 1024)

    def forward(self, h_rgb, pcd):
        h_rgb = F.relu(self.Dense_0(h_rgb))
        h_pcd = F.relu(self.Dense_1(pcd))
        feat1 = torch.cat([h_rgb, h_pcd], dim=-1)
        h_rgb = F.relu(self.Dense_2(h_rgb))
        h_pcd = F.relu(self.Dense_3(h_pcd))
        feat2 = torch.cat([h_rgb, h_pcd], dim=-1)
        h = F.relu(self.Dense_4(feat2))
        h = F.relu(self.Dense_5(h))
        feat3 = h.mean(dim=1, keepdim=True).expand(-1, h.shape[1], -1)
        return torch.cat([feat1, feat2, feat3], dim=-1)


class PoseNet(nn.Module):
    def __init__(
        self,
        n_fg_class: int,
        n_point: int = 1000,
        centerize_pcd: bool = True,
        pretrained_resnet18: bool = False,
        backbone_width: int = 64,
        psp_bottleneck: int = 1024,
        psp_up: tuple = (256, 64, 64),
        tower_widths: tuple = (640, 256, 128),
    ):
        super().__init__()
        self.n_fg_class = n_fg_class
        self.n_point = n_point
        self.centerize_pcd = centerize_pcd
        if pretrained_resnet18:
            self.resnet_extractor = ResNet18Extractor()
            backbone_channels = 512
        else:
            self.resnet_extractor = DilatedResNet18(base_width=backbone_width)
            backbone_channels = backbone_width * 8
        self.pspnet_extractor = PSPNetExtractor(
            in_channels=backbone_channels,
            bottleneck_channels=psp_bottleneck, up_channels=psp_up)
        self.posenet_extractor = PoseNetExtractor()
        self.heads = PoseHeads(FEATURE_CHANNELS, n_fg_class, tower_widths)

    def forward(
        self,
        *,
        class_id: torch.Tensor,
        rgb: torch.Tensor,
        pcd: torch.Tensor,
        sample_indices: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        train: bool = False,
        dropout_generator: Optional[torch.Generator] = None,
    ):
        """Per-point poses.

        ``class_id (B,)`` one-based; ``rgb (B, H, W, 3)`` uint8-range;
        ``pcd (B, H, W, 3)`` camera frame, NaN = invalid;
        ``sample_indices (B, n_point)`` flat pixel indices, drawn with
        ``generator`` when None; ``train`` turns on the PSPNet dropout,
        whose masks come from ``dropout_generator``. The points enter the
        tower centred on the masked median of the instance's points (with
        ``centerize_pcd``), and the translations are offsets from the
        sampled camera-frame points. Returns quaternions ``(B, P, 4)``,
        translations ``(B, P, 3)`` and confidences ``(B, P)``.
        """
        B, H, W, _ = rgb.shape
        mask = ~torch.isnan(pcd).any(dim=-1)
        with annotate("model.backbone"):
            h_rgb = self.pspnet_extractor(
                self.resnet_extractor(rgb), train=train,
                generator=dropout_generator)  # (B, 32, H, W)
        if sample_indices is None:
            sample_indices = sample_mask_indices(mask, self.n_point, generator)
        sample_indices = sample_indices.to(torch.int64)
        C = h_rgb.shape[1]
        values = torch.gather(
            h_rgb.reshape(B, C, H * W), 2,
            sample_indices[:, None, :].expand(-1, C, -1),
        ).transpose(1, 2)  # (B, P, 32)
        points = torch.nan_to_num(gather_pixels(pcd, sample_indices))
        if self.centerize_pcd:
            center = masked_median(pcd.reshape(B, -1, 3), mask.reshape(B, -1))
            points_in = points - center[:, None, :]
        else:
            points_in = points

        feat = self.posenet_extractor(values, points_in)
        with annotate("model.heads"):
            cls_rot, cls_trans, cls_conf = self.heads(feat)
            rot, trans, conf = select_class(cls_rot, cls_trans, cls_conf,
                                            class_id.to(torch.int64) - 1)
            trans = points + trans
        return rot, trans, conf
