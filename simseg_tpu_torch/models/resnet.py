"""ResNet image tower returning the spatial feature map (port of
``simseg_tpu/models/resnet.py``).

Parity: reference ``simseg/models/backbones/mml/timm_builder.py:7-20``
(timm CNN backbones with ``global_pool=''``). Module and parameter names
are torchvision's / timm's (``conv1``, ``bn1``, ``layer1.0.conv1``, ...,
``layer1.0.downsample.0`` / ``.1``), so a reference state dict loads as it
is. BatchNorm is flax's (``models/layers.BatchNorm``): running statistics
unless ``train_bn``, the reference's ``freeze_cnn_bn=False`` training mode,
where the batch's (the global batch's in a world) are used and the running
averages move.

Layout: the tower takes NHWC images, as the JAX tower does, and computes
on an NCHW view of them whose strides are channels-last (a permute, no
copy), which cuDNN's convolutions keep; it returns the (B, H/32, W/32, C)
map (the last stage's stride: 4 · 2^(stages - 1)). Compute runs in
``compute_dtype`` (None: the parameters' dtype), weights cast at use.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from simseg_tpu_torch.models.layers import BatchNorm, Conv2d


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> Conv2d:
    return Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class _Downsample(nn.Sequential):
    """``downsample.0`` (1x1 strided conv) and ``downsample.1`` (BN)."""

    def __init__(self, cin: int, cout: int, stride: int) -> None:
        super().__init__(_conv(cin, cout, 1, stride), BatchNorm(cout))

    def forward(self, x, train_bn: bool = False):
        return self[1](self[0](x), train_bn)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False) -> None:
        super().__init__()
        self.conv1 = _conv(cin, planes, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = BatchNorm(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = (_Downsample(cin, planes * 4, stride) if downsample
                           else None)

    def forward(self, x: torch.Tensor, train_bn: bool = False) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x), train_bn))
        out = F.relu(self.bn2(self.conv2(out), train_bn))
        out = self.bn3(self.conv3(out), train_bn)
        identity = x if self.downsample is None else self.downsample(x, train_bn)
        return F.relu(out + identity)


class BasicBlock(nn.Module):
    """torchvision/timm BasicBlock (resnet18/34): two 3x3 convs."""

    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False) -> None:
        super().__init__()
        self.conv1 = _conv(cin, planes, 3, stride)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = BatchNorm(planes)
        self.downsample = (_Downsample(cin, planes, stride) if downsample
                           else None)

    def forward(self, x: torch.Tensor, train_bn: bool = False) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x), train_bn))
        out = self.bn2(self.conv2(out), train_bn)
        identity = x if self.downsample is None else self.downsample(x, train_bn)
        return F.relu(out + identity)


class ResNet(nn.Module):
    """(B, H, W, 3) -> the (B, h, w, C) map (timm ``global_pool=''``)."""

    quant = None

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 block: str = "bottleneck") -> None:
        super().__init__()
        self.conv1 = Conv2d(3, width, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(width)
        basic = block == "basic"
        cls = BasicBlock if basic else Bottleneck
        cin, planes = width, width
        for stage, blocks in enumerate(layers):
            stride = 1 if stage == 0 else 2
            mods = []
            for i in range(blocks):
                # the bottleneck's first block always changes channels
                down = (i == 0 and stage > 0) if basic else (i == 0)
                mods.append(cls(cin, planes, stride if i == 0 else 1, down))
                cin = planes * cls.expansion
            setattr(self, f"layer{stage + 1}", nn.ModuleList(mods))
            planes *= 2
        self.num_stages = len(layers)
        self.num_features = cin
        self.patch_size = 4 * 2 ** (len(layers) - 1)
        self.compute_dtype: Optional[torch.dtype] = None

    def forward(self, images: torch.Tensor, key=None,
                train_bn: bool = False) -> torch.Tensor:
        dtype = self.compute_dtype or self.conv1.weight.dtype
        x = images.to(dtype).permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x), train_bn))
        # -inf padding, as flax's max_pool pads
        x = F.max_pool2d(x, 3, 2, 1)
        for stage in range(self.num_stages):
            for blk in getattr(self, f"layer{stage + 1}"):
                x = blk(x, train_bn)
        return x.permute(0, 2, 3, 1)


# JAX's tag tables (``simseg_tpu/models/resnet.py:141-155``)
RESNET_CONFIGS = {
    "resnet_test": dict(layers=(1, 1), width=8),
    "resnet_basic_test": dict(layers=(1, 1), width=8, block="basic"),
}

_RESNET_FAMILY = {
    "resnet18": dict(layers=(2, 2, 2, 2), width=64, block="basic"),
    "resnet34": dict(layers=(3, 4, 6, 3), width=64, block="basic"),
    "resnet50": dict(layers=(3, 4, 6, 3), width=64),
    "resnet101": dict(layers=(3, 4, 23, 3), width=64),
    "resnet152": dict(layers=(3, 8, 36, 3), width=64),
}


def build_resnet(tag: str, arch: Optional[dict] = None) -> ResNet:
    """A ResNet from its tag (weight suffixes after '.' ignored) and the
    ``arch`` overrides (layers / width / block); JAX's error for a tag of
    no known CNN family."""
    spec = RESNET_CONFIGS.get(tag) or _RESNET_FAMILY.get(tag.split(".")[0])
    spec = dict(spec) if spec else {}
    if arch:
        spec.update({k: v for k, v in dict(arch).items() if v is not None})
    if "layers" not in spec:
        raise KeyError(
            f"Unknown CNN tag '{tag}'. Supported image towers: any standard "
            f"timm ViT tag (pattern-parsed, models/vit.py), the ResNet "
            f"family {sorted(RESNET_CONFIGS) + sorted(_RESNET_FAMILY)}, "
            "convnext_<size> (models/convnext.py), efficientnet_b0..b7 "
            "(models/efficientnet.py), or an arbitrary shape declared via "
            "model.image_encoder.arch (ResNet: layers/width/block; "
            "ConvNeXt: depths/dims; EfficientNet: stages/stem_chs/"
            "head_chs). Other timm CNN families are not implemented."
        )
    spec["layers"] = tuple(spec["layers"])
    return ResNet(**spec)
