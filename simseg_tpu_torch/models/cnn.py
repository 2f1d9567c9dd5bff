"""CNN tower dispatch by tag family (port of ``simseg_tpu/models/cnn.py``).

Parity: reference ``simseg/models/backbones/mml/timm_builder.py:7-20``
resolves any timm tag through timm; the ResNet, ConvNeXt and EfficientNet
families are built here and any other tag is refused (``build_resnet``'s
error names the supported ones). A shape without a known tag rides
``model.image_encoder.arch``, its family read from its keys: ``layers``
ResNet, ``dims`` ConvNeXt, ``stages`` EfficientNet.

Every CNN tower takes ``(images (B, H, W, 3), key=None, train_bn=False)``
and returns the (B, h, w, C) map; it carries ``num_features`` (C),
``patch_size`` (its total stride: the seg eval's grid step) and
``compute_dtype``.
"""

from __future__ import annotations

from typing import Optional

from simseg_tpu_torch.models.convnext import build_convnext, resolve_convnext_config
from simseg_tpu_torch.models.efficientnet import (build_efficientnet,
                                                  resolve_efficientnet_config)
from simseg_tpu_torch.models.resnet import build_resnet


def build_cnn(tag: str, arch: Optional[dict] = None):
    arch = dict(arch) if arch else {}
    if resolve_convnext_config(tag) is not None or "dims" in arch:
        return build_convnext(tag, arch=arch)
    if resolve_efficientnet_config(tag) is not None or "stages" in arch:
        return build_efficientnet(tag, arch=arch)
    return build_resnet(tag, arch=arch)
