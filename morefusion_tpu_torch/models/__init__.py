"""Pose-prediction models of the port (``morefusion_tpu.models``)."""

# flake8: noqa: F401

from . import losses
from .convert_jax import load_jax_npz
from .convert_jax import params_from_jax
from .convert_jax import params_to_jax
from .convert_jax import variables_from_jax
from .convert_torch import convert_torchvision_resnet18
from .convert_torch import graft_resnet18
from .heads import PoseHeads
from .posenet import PoseNet
from .posenet import PoseNetExtractor
from .heads import select_class
from .pspnet import PSPNetExtractor
from .resnet import DilatedResNet18
from .resnet import DilatedResNet34
from .resnet import ResNet18Extractor
from .resnet import normalize_rgb
from .sampling import compute_origin
from .sampling import gather_pixels
from .sampling import masked_median
from .sampling import sample_mask_indices
from .segmentation import SegmentationNode
from .segmentation import UNetSegmentation
from .singleview_3d import SingleView3D


def tiny_singleview3d(n_fg_class, n_point=32, with_occupancy=False, **kw):
    """Test-sized SingleView3D: the topology of
    ``morefusion_tpu.models.tiny_singleview3d`` at its narrow widths."""
    return SingleView3D(
        n_fg_class=n_fg_class,
        n_point=n_point,
        with_occupancy=with_occupancy,
        backbone_width=8,
        psp_bottleneck=64,
        psp_up=(32, 16, 16),
        conv3_channels=32,
        conv4_channels=64,
        tower_widths=(64, 32, 16),
        **kw,
    )
