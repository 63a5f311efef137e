"""SingleView3D: the volumetric pose-prediction model of MoreFusion.

Port of ``morefusion_tpu/models/singleview_3d.py::SingleView3D``:
DilatedResNet18 (or, with ``pretrained_resnet18``, the frozen-BN
``ResNet18Extractor``) + PSPNet give per-pixel 32-channel features; ``n_point``
masked pixels are sampled per instance; point MLPs build 72/144-channel
point features, which are scatter-mean voxelized into a ``voxel_dim^3``
grid (with the occupancy branch: two 3D convs over the no-entry grid
concatenated in); two strided 3D convs are trilinearly sampled back onto
the points; per-class heads give per-point poses. Submodule names follow
the flax parameter tree (see ``convert_jax.py``).

``compute_dtype`` (fp32 or bf16) is the dtype of the conv and dense stacks,
as in JAX: the parameters stay fp32 and each layer casts its input and
weight. Explicit casts, not ``torch.autocast``, whose op lists differ from
flax's (it would run ``ResNet18Extractor`` in bf16, where JAX keeps it in
fp32). The log-softmax, the heads' output layers and the pose outputs stay
fp32.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from ..functions.voxelization import (
    average_voxelization_3d,
    interpolate_voxel_grid,
)
from .heads import PoseHeads, select_class
from .layers import Conv3d, Linear
from .pspnet import PSPNetExtractor
from .resnet import DilatedResNet18, ResNet18Extractor
from .sampling import compute_origin, gather_pixels, sample_mask_indices


class SingleView3D(nn.Module):
    def __init__(
        self,
        n_fg_class: int,
        n_point: int = 1000,
        voxel_dim: int = 32,
        with_occupancy: bool = False,
        pretrained_resnet18: bool = False,
        backbone_width: int = 64,
        psp_bottleneck: int = 1024,
        psp_up: tuple = (256, 64, 64),
        conv3_channels: int = 256,
        conv4_channels: int = 512,
        tower_widths: tuple = (640, 256, 128),
        point_widths: tuple = (64, 8, 128, 16),
        compute_dtype=torch.float32,
    ):
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype {compute_dtype}: fp32 or bf16")
        self.n_fg_class = n_fg_class
        self.n_point = n_point
        self.voxel_dim = voxel_dim
        self.with_occupancy = with_occupancy
        self.compute_dtype = compute_dtype
        dt = dict(compute_dtype=compute_dtype)
        if pretrained_resnet18:
            self.resnet_extractor = ResNet18Extractor()
            backbone_channels = 512
        else:
            self.resnet_extractor = DilatedResNet18(base_width=backbone_width,
                                                    **dt)
            backbone_channels = backbone_width * 8
        self.pspnet_extractor = PSPNetExtractor(
            in_channels=backbone_channels,
            bottleneck_channels=psp_bottleneck, up_channels=psp_up, **dt,
        )
        w1r, w1p, w2r, w2p = point_widths
        self.conv1_rgb = Linear(32, w1r, **dt)
        self.conv1_pcd = Linear(3, w1p, **dt)
        self.conv2_rgb = Linear(w1r, w2r, **dt)
        self.conv2_pcd = Linear(w1p, w2p, **dt)
        voxel_channels = w2r + w2p
        if with_occupancy:
            self.conv1_occ = Conv3d(1, 8, 3, padding=1, **dt)
            self.conv2_occ = Conv3d(8, 16, 3, padding=2, dilation=2, **dt)
            voxel_channels += 16
        self.conv3 = Conv3d(voxel_channels, conv3_channels, 4, stride=2,
                            padding=1, **dt)
        self.conv4 = Conv3d(conv3_channels, conv4_channels, 4, stride=2,
                            padding=1, **dt)
        feat_channels = (w1r + w1p + w2r + w2p + conv3_channels
                         + conv4_channels)
        self.heads = PoseHeads(feat_channels, n_fg_class, tower_widths, **dt)

    def _extract(self, values, points, grid_nontarget_empty):
        """``values (B, P, 32)`` and voxel-frame ``points (B, P, 3)`` ->
        ``(B, P, C)`` fused point features."""
        B, P, _ = values.shape
        V = self.voxel_dim
        to_center = ((V / 2.0 - 0.5) - points).to(self.compute_dtype)
        values = values.to(self.compute_dtype)
        h_rgb = F.relu(self.conv1_rgb(values))
        h_pcd = F.relu(self.conv1_pcd(to_center))
        feat1 = torch.cat([h_rgb, h_pcd], dim=-1)
        h_rgb = F.relu(self.conv2_rgb(h_rgb))
        h_pcd = F.relu(self.conv2_pcd(h_pcd))
        feat2 = torch.cat([h_rgb, h_pcd], dim=-1)

        batch_indices = torch.arange(B, device=values.device).repeat_interleave(P)
        flat_points = points.reshape(B * P, 3)
        voxelized = average_voxelization_3d(
            feat2.reshape(B * P, -1), flat_points, batch_indices,
            batch_size=B, origin=(0.0, 0.0, 0.0), pitch=1.0,
            dimensions=(V, V, V),
        ).permute(0, 4, 1, 2, 3)  # (B, C, V, V, V)
        if self.with_occupancy:
            # fp32 into the convs, which cast it, as in JAX
            occ = grid_nontarget_empty.to(torch.float32)[:, None]
            h_occ = F.relu(self.conv1_occ(occ))
            h_occ = F.relu(self.conv2_occ(h_occ))
            voxelized = torch.cat([voxelized, h_occ], dim=1)

        h = F.relu(self.conv3(voxelized))
        feat3 = interpolate_voxel_grid(
            h.permute(0, 2, 3, 4, 1), flat_points / 2.0, batch_indices
        ).reshape(B, P, -1)
        h = F.relu(self.conv4(h))
        feat4 = interpolate_voxel_grid(
            h.permute(0, 2, 3, 4, 1), flat_points / 4.0, batch_indices
        ).reshape(B, P, -1)
        return torch.cat([feat1, feat2, feat3, feat4], dim=-1)

    def forward(
        self,
        *,
        class_id: torch.Tensor,
        rgb: torch.Tensor,
        pcd: torch.Tensor,
        pitch: torch.Tensor,
        origin: Optional[torch.Tensor] = None,
        grid_nontarget_empty: Optional[torch.Tensor] = None,
        sample_indices: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        train: bool = False,
        dropout_generator: Optional[torch.Generator] = None,
    ):
        """Per-point poses.

        ``class_id (B,)`` one-based; ``rgb (B, H, W, 3)`` uint8-range;
        ``pcd (B, H, W, 3)`` camera frame, NaN = invalid; ``pitch (B,)``;
        ``origin (B, 3)`` (from the masked median when None);
        ``grid_nontarget_empty (B, V, V, V)`` (occupancy variant);
        ``sample_indices (B, n_point)`` flat pixel indices, drawn with
        ``generator`` when None; ``train`` turns on the PSPNet dropout, whose
        masks come from ``dropout_generator``. Returns quaternions
        ``(B, P, 4)``, camera-frame translations ``(B, P, 3)`` and
        confidences ``(B, P)``.
        """
        B, H, W, _ = rgb.shape
        V = self.voxel_dim
        mask = ~torch.isnan(pcd).any(dim=-1)
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
        points_cam = torch.nan_to_num(gather_pixels(pcd, sample_indices))
        if origin is None:
            origin = compute_origin(pcd, mask, pitch, V)
        points = (points_cam - origin[:, None, :]) / pitch[:, None, None]

        feat = self._extract(values, points, grid_nontarget_empty)
        cls_rot, cls_trans, cls_conf = self.heads(feat)
        rot, trans, conf = select_class(cls_rot, cls_trans, cls_conf,
                                        class_id.to(torch.int64) - 1)
        trans = points_cam + trans * pitch[:, None, None]
        return rot, trans, conf
