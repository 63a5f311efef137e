"""torchvision-layout ResNet18 weights onto the port's ``ResNet18Extractor``.

Port of ``morefusion_tpu/models/convert_torch.py``. The reference's
``--pretrained-resnet18`` recipe starts its extractor from an ImageNet
ResNet18 and freezes BN (``morefusion/models/resnet.py:7-52``). Load a
torchvision checkpoint (``resnet18-f37072fd.pth``) with ``torch.load`` and
map it with ``convert_torchvision_resnet18``:

    conv1 / bn1              -> Conv_0 / BatchNorm_0
    layer1.{0,1}             -> BNBasicBlock_{0,1}      (64 ch)
    layer2.{0,1}             -> BNBasicBlock_{2,3}      (128 ch, downsample)
    layer3.{0,1}             -> BNBasicBlock_{4,5}      (256 ch, dilation 2)
    layer4.{0,1}             -> BNBasicBlock_{6,7}      (512 ch, dilation 4)

The res4/res5 stride-2 convolutions are applied at stride 1 with dilation
(weights unchanged), the reference's dilated conversion. Both layouts are
PyTorch's, so tensors move across unchanged; ``num_batches_tracked`` and the
classifier (``fc``) are dropped.
"""

from __future__ import annotations

from typing import Dict

import torch

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def _tensor(v):
    return torch.as_tensor(v, dtype=torch.float32).detach().clone()


def convert_torchvision_resnet18(state_dict: Dict) -> Dict[str, torch.Tensor]:
    """torchvision resnet18 ``state_dict`` -> a state dict for
    ``ResNet18Extractor``."""
    if "state_dict" in state_dict and "conv1.weight" not in state_dict:
        state_dict = state_dict["state_dict"]
    pairs = [("conv1", "Conv_0"), ("bn1", "BatchNorm_0")]
    i = 0
    for layer in (1, 2, 3, 4):
        for sub in (0, 1):
            src, dst = f"layer{layer}.{sub}", f"BNBasicBlock_{i}"
            pairs += [(f"{src}.conv1", f"{dst}.Conv_0"),
                      (f"{src}.bn1", f"{dst}.BatchNorm_0"),
                      (f"{src}.conv2", f"{dst}.Conv_1"),
                      (f"{src}.bn2", f"{dst}.BatchNorm_1")]
            if layer > 1 and sub == 0:
                pairs += [(f"{src}.downsample.0", f"{dst}.Conv_2"),
                          (f"{src}.downsample.1", f"{dst}.BatchNorm_2")]
            i += 1
    out = {}
    for src, dst in pairs:
        leaves = _BN_LEAVES if "BatchNorm" in dst else ("weight",)
        for leaf in leaves:
            out[f"{dst}.{leaf}"] = _tensor(state_dict[f"{src}.{leaf}"])
    return out


def graft_resnet18(state_dict: Dict, converted: Dict) -> Dict:
    """A full model's state dict (built with ``pretrained_resnet18=True``)
    with its ``resnet_extractor`` replaced by ``converted``; a new dict."""
    out = {k: v for k, v in state_dict.items()
           if not k.startswith("resnet_extractor.")}
    out.update({f"resnet_extractor.{k}": v for k, v in converted.items()})
    return out
